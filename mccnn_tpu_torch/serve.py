"""Serving: an inference closure and a fixed-batch predictor
(port of ``mccnn_tpu/serve.py:42-56`` and ``:140-159``).

``Predictor`` keeps the reference's static-batch serving contract: a request
smaller than ``batch_size`` is padded by repeating row 0 and the result is
sliced back (each output of a tuple, as MCClassH's ``(joint, a, b)``, as the
reference's ``jax.tree.map`` slices them); a larger one is refused. Requests move to the model's device.
The StableHLO bundles of the reference have no counterpart yet
(``torch.export`` comes later).
"""

from __future__ import annotations

from typing import Callable

import torch

from .train.state import _model_args

def make_predict_fn(model: torch.nn.Module) -> Callable:
    """Eval-mode, ``inference_mode`` closure over ``(points, mask[, features][,
    category_onehot])`` — the positional contract of
    ``mccnn_tpu/train/state.py:48-54`` (the one-hot only when given)."""
    model.eval()

    def predict(points, mask, features=None, category_onehot=None):
        batch = {"points": points, "mask": mask, "features": features}
        if category_onehot is not None:
            batch["category_onehot"] = category_onehot
        with torch.inference_mode():
            return model(*_model_args(batch))

    return predict


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


class Predictor:
    """Serve request batches of at most ``batch_size`` clouds."""

    def __init__(self, model: torch.nn.Module, batch_size: int):
        self.batch_size = batch_size
        self.device = _device_of(model)
        self._predict = make_predict_fn(model)

    def predict(self, batch: dict) -> torch.Tensor:
        """``batch``: ``points (b, N, 3)``, ``mask (b, N)`` and optional
        ``features (b, N, C)`` and ``category_onehot (b, K)`` (MCSeg on
        ShapeNet), numpy arrays or tensors. Returns ``(b, ...)``
        outputs on the model's device (a tuple of them for a model that
        returns one)."""
        b = int(batch["points"].shape[0])
        if b > self.batch_size:
            raise ValueError(
                f"request batch {b} exceeds the serving batch {self.batch_size}; "
                "split the request"
            )
        args = []
        for key in ("points", "mask", "features", "category_onehot"):
            v = batch.get(key)
            if v is None:
                args.append(None)
                continue
            t = torch.as_tensor(v)
            if b < self.batch_size:
                t = torch.cat([t, t[:1].expand(self.batch_size - b, *t.shape[1:])])
            args.append(t.to(self.device))
        out = self._predict(*args)
        return tuple(x[:b] for x in out) if isinstance(out, tuple) else out[:b]
