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

and, for MCSeg's and MCClass's explicit names:

  {stem,enc_i_j,dec_i_j,down_i_j,same_i}/kernel_*      -> convs.<name>.kernel_*
  {stem_bn,enc_bn_k,enc_mix_bn_k,dec_bn_k,dec_mix_bn_k}/MaskedBatchNorm_0/*
                                                       -> bns.<name>.bn.*
  {enc,dec}_mix_k, mix_k, same_mix_k/Dense_0/{kernel,bias}
                                                       -> mixes.<name>.{weight,bias}

MCNorm's output layer and MCNormS's trunk:

  normals/{kernel,bias}                                -> normals.{weight,bias}
  trunk/<a leaf of MCNorm>                             -> trunk.<its name>

(MCNorm's convs, ``dec_mix_k`` and ``BatchNormReluDropout_k`` take the rules
above), and MCClassH's two trunks and three heads:

  path_{a,b}/<a leaf of the rules above>               -> path_{a,b}.<its name>
  {a,b,joint}_fc{1,2}/Dense_0/{kernel,bias}            -> heads.<name>.dense.*
  {a,b,joint}_fc{1,2}/{BatchNorm_0,MaskedBatchNorm_0}/* -> heads.<name>.bn.*
  {a,b,joint}_logits/{kernel,bias}                     -> heads.<name>.{weight,bias}

Flax numbers its auto-named modules (``BatchNormReluDropout_k``,
``FullyConnected_k``) per scope in call order, and the port's ``bn_relus`` /
``fcs`` lists hold them in the same order.

Flax ``Dense`` kernels are (in, out); torch ``Linear`` weights are (out, in),
so those are transposed. Any flax leaf left unused, and any torch parameter or
buffer left unset, raises.

``load_flax_train_state`` carries a whole JAX train state across (parameters,
BN statistics, optax Adam's moments and count, the step), so that a JAX run
can be resumed in the port.
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
    # MCSeg's and MCClass's explicit names (mccnn_tpu/models/mcseg.py:66-139,
    # mcclass.py:45-84)
    (r"(stem|enc_\d+_\d+|dec_\d+_\d+|down_\d+_\d+|same_\d+)/(kernel_(?:w1|b1|w2|b2))",
     r"convs.\1.\2", False),
    (r"((?:stem|enc|enc_mix|dec|dec_mix)_bn(?:_\d+)?)/MaskedBatchNorm_0/"
     r"(scale|bias|mean|var|count)", r"bns.\1.bn.\2", False),
    (r"((?:enc_|dec_|same_)?mix_\d+)/Dense_0/kernel", r"mixes.\1.weight", True),
    (r"((?:enc_|dec_|same_)?mix_\d+)/Dense_0/bias", r"mixes.\1.bias", False),
    # MCClassH's heads (mccnn_tpu/models/mcclass_h.py:133-146)
    (r"((?:a|b|joint)_fc[12])/Dense_0/kernel", r"heads.\1.dense.weight", True),
    (r"((?:a|b|joint)_fc[12])/Dense_0/bias", r"heads.\1.dense.bias", False),
    (r"((?:a|b|joint)_fc[12])/(?:BatchNorm_0|MaskedBatchNorm_0)/(scale|bias|mean|var|count)",
     r"heads.\1.bn.\2", False),
    (r"((?:a|b|joint)_logits)/kernel", r"heads.\1.weight", True),
    (r"((?:a|b|joint)_logits)/bias", r"heads.\1.bias", False),
    # MCNorm's output layer (mccnn_tpu/models/mcnorm.py:76)
    (r"normals/kernel", "normals.weight", True),
    (r"normals/bias", "normals.bias", False),
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
    trunk = re.fullmatch(r"(path_[ab]|trunk)/(.+)", flax_path)  # MCClassH's, MCNormS's trunks
    if trunk:
        name, transpose = torch_name(trunk.group(2))
        return f"{trunk.group(1)}.{name}", transpose
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


@torch.no_grad()
def load_flax_train_state(state, flax_state: dict) -> None:
    """Load a JAX ``TrainState`` into the port's ``train.TrainState`` in place.

    ``flax_state`` holds numpy arrays: ``params`` and ``batch_stats`` (nested
    as in flax, BN ``count`` included), ``mu`` and ``nu`` (optax Adam's first
    and second moments, nested like ``params``), ``count`` (Adam's step count)
    and ``step``. The moments land in ``torch.optim.Adam``'s ``exp_avg`` /
    ``exp_avg_sq`` of the matching parameters; the dropout generator keeps
    its own state (``jax.random`` keys have no torch counterpart).
    """
    model, optimizer = state.model, state.optimizer
    load_flax_variables(model, {"params": flax_state["params"],
                                "batch_stats": flax_state["batch_stats"]})
    index = {id(p): i for i, p in enumerate(optimizer.params)}
    named = dict(model.named_parameters())
    moments: dict[int, dict] = {}
    for key in ("mu", "nu"):
        for path, value in _flatten(flax_state[key]):
            name, transpose = torch_name(path)
            if name not in named:
                raise KeyError(f"Adam {key} leaf {path} maps to {name!r}, not a parameter")
            p = named[name]
            value = value.T if transpose else value
            if tuple(p.shape) != value.shape:
                raise ValueError(f"Adam {key}/{path}: shape {value.shape} does not match "
                                 f"{name} {tuple(p.shape)}")
            slot = "exp_avg" if key == "mu" else "exp_avg_sq"
            moments.setdefault(index[id(p)], {})[slot] = torch.tensor(value, dtype=p.dtype)
    if len(moments) != len(optimizer.params) or any(len(m) != 2 for m in moments.values()):
        raise KeyError("Adam moments must cover every parameter")
    count = float(np.asarray(flax_state["count"]))
    sd = optimizer.adam.state_dict()
    sd["state"] = {i: {"step": torch.tensor(count), **m} for i, m in moments.items()}
    optimizer.adam.load_state_dict(sd)
    optimizer.count = int(np.asarray(flax_state["step"]))
