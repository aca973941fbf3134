"""Load a JAX (flax) checkpoint's variables into the port's modules.

``load_flax_variables(model, {"params": ..., "batch_stats": ...})`` takes the
JAX model's variables as nested dicts of numpy arrays and keys on the flax
module names:

  conv_{i}_{j}/kernel_{w1,b1,w2,b2}                    -> convs.conv_{i}_{j}.kernel_*
  BatchNormReluDropout_k/MaskedBatchNorm_0/{scale,bias,mean,var,count}
                                                       -> bn_relus.k.bn.*
  FullyConnected_k/Dense_0/{kernel,bias}               -> fcs.k.dense.{weight,bias}
  FullyConnected_k/{BatchNorm_0,MaskedBatchNorm_0}/*   -> fcs.k.bn.*
  logits/{kernel,bias}                                 -> logits.{weight,bias}

Flax ``Dense`` kernels are (in, out); torch ``Linear`` weights are (out, in),
so those are transposed. Any flax leaf left unused, and any torch parameter or
buffer left unset, raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# (flax path pattern, torch name template, transpose?)
_RULES = [
    (r"(conv_\d+_\d+)/(kernel_(?:w1|b1|w2|b2))", r"convs.\1.\2", False),
    (r"BatchNormReluDropout_(\d+)/MaskedBatchNorm_0/(scale|bias|mean|var|count)",
     r"bn_relus.\1.bn.\2", False),
    (r"FullyConnected_(\d+)/Dense_0/kernel", r"fcs.\1.dense.weight", True),
    (r"FullyConnected_(\d+)/Dense_0/bias", r"fcs.\1.dense.bias", False),
    (r"FullyConnected_(\d+)/(?:BatchNorm_0|MaskedBatchNorm_0)/(scale|bias|mean|var|count)",
     r"fcs.\1.bn.\2", False),
    (r"logits/kernel", "logits.weight", True),
    (r"logits/bias", "logits.bias", False),
]


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def torch_name(flax_path: str) -> tuple[str, bool]:
    """The torch state-dict key (and whether to transpose) for a flax leaf path."""
    for pattern, template, transpose in _RULES:
        m = re.fullmatch(pattern, flax_path)
        if m:
            return m.expand(template), transpose
    raise KeyError(f"no torch counterpart for flax leaf {flax_path!r}")


@torch.no_grad()
def load_flax_variables(model: torch.nn.Module, variables: dict) -> None:
    """Copy ``{"params": ..., "batch_stats": ...}`` into ``model`` in place."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections: {sorted(unknown)}")
    state = dict(model.state_dict(keep_vars=True))
    unset = set(state)
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            name, transpose = torch_name(path)
            if name not in state:
                raise KeyError(f"flax leaf {collection}/{path} maps to {name!r}, "
                               "which the model does not have")
            if name not in unset:
                raise KeyError(f"torch tensor {name!r} set twice")
            if transpose:
                value = value.T
            target = state[name]
            if tuple(target.shape) != value.shape:
                raise ValueError(f"{collection}/{path}: shape {value.shape} does not "
                                 f"match {name} {tuple(target.shape)}")
            target.copy_(torch.tensor(value, dtype=target.dtype))
            unset.discard(name)
    if unset:
        raise KeyError(f"torch parameters/buffers left unset: {sorted(unset)}")


def load_npz_variables(path: str) -> dict:
    """Read flat ``params/...`` and ``batch_stats/...`` keys of an ``.npz``
    into the nested dicts ``load_flax_variables`` takes."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return out
