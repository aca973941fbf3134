"""Train state, optimizer and train step (port of ``mccnn_tpu/train/state.py:20-139``).

The reference chains optax transforms: ``clip_by_global_norm`` (optional),
``add_decayed_weights`` (optional L2 added to the gradient) and ``adam`` with
a staircase exponential-decay learning rate. ``Optimizer`` does the same over
a module's parameters with ``torch.optim.Adam`` (optax's b1 0.9, b2 0.999,
eps 1e-8; its ``weight_decay`` is the same L2 added to the gradient before
the moments) and its own clip and schedule. Neither is a TPU kernel.

A step runs the model in training mode (batch BN moments, running-statistic
updates, dropout from the state's generator), the loss, the backward through
the MC convs' K2 and K6 (on CUDA tensors) and one optimizer update, in place.

A model with a tile capacity (``tile_sites`` and ``tile_pairs`` set)
reports the steps its tile kernels dropped (``tile_overflow``,
``train/state.py:106-115`` of the reference). A step whose forward dropped
any commits nothing: no backward, no optimizer
update, and its BN running statistics and dropout generators are put back as
they were, so that the caller can grow the budgets and run the same step
again with the same draws, as the reference re-runs a discarded step from
the same state and ``rng`` (``tasks/common.py:345-381``). Checking after the
forward gives the reference's answer (it checks after the whole step) and
saves the backward; it waits for the device once a step, for tile models
only. A model without a capacity (MCSeg on the bucket path, whose grid
overflow drops points silently, as in the reference) takes one forward, one
backward and the update, and nothing here waits for the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from ..models.layers import Dropout, set_dropout_generator


class StaircaseDecay:
    """``optax.exponential_decay(lr, decay_steps, decay_rate, staircase=True)``:
    ``lr * decay_rate ** floor(count / decay_steps)``."""

    def __init__(self, lr: float, decay_steps: int, decay_rate: float):
        self.lr, self.decay_steps, self.decay_rate = lr, decay_steps, decay_rate

    def __call__(self, count: int) -> float:
        return self.lr * self.decay_rate ** (count // self.decay_steps)


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``: when the global norm of the gradients
    reaches ``max_norm``, each becomes ``g / norm * max_norm``. optax adds no
    epsilon to the norm, where ``torch.nn.utils.clip_grad_norm_`` adds 1e-6,
    so the port clips here. Returns the norm; never syncs with the host."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class Optimizer:
    """``make_optimizer``'s chain over a module's parameters. ``count`` is
    optax's step count: the schedule reads it before the update."""

    def __init__(self, params: Iterable[nn.Parameter], schedule: StaircaseDecay,
                 weight_decay: float = 0.0, grad_clip: float | None = None):
        self.params = list(params)
        self.schedule, self.grad_clip = schedule, grad_clip
        self.adam = torch.optim.Adam(self.params, lr=schedule(0), betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=weight_decay)
        self.count = 0

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.grad_clip is not None:
            clip_by_global_norm_(self.params, self.grad_clip)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def make_optimizer(
    params: Iterable[nn.Parameter],
    lr: float = 1e-3,
    decay_steps: int = 20_000,
    decay_rate: float = 0.7,
    weight_decay: float = 0.0,
    grad_clip: float | None = None,
) -> Optimizer:
    """Adam + staircase exponential decay (the reference's schedule shape)."""
    return Optimizer(params, StaircaseDecay(lr, decay_steps, decay_rate),
                     weight_decay=weight_decay, grad_clip=grad_clip)


@dataclass
class TrainState:
    """The module, its optimizer (with the schedule and the step count) and
    the dropout generator: everything a checkpoint holds."""

    model: nn.Module
    optimizer: Optimizer
    generator: torch.Generator

    @property
    def step(self) -> int:
        return self.optimizer.count

    @property
    def schedule(self) -> StaircaseDecay:
        return self.optimizer.schedule


def init_state(model: nn.Module, optimizer: Optimizer, seed: int) -> TrainState:
    """A train state whose dropout generator lives on the model's device,
    seeded with ``seed``."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    set_dropout_generator(model, generator)
    return TrainState(model=model, optimizer=optimizer, generator=generator)


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy arrays (or tensors) -> tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device)
            for k, v in batch.items()}


def _model_args(batch: dict) -> tuple:
    """(points, mask, features[, category_onehot]) — the positional contract
    of the model zoo (``mccnn_tpu/train/state.py:48-54``): MCSeg also takes
    the category one-hot of a ShapeNet batch."""
    args = [batch["points"], batch["mask"], batch.get("features")]
    if "category_onehot" in batch:
        args.append(batch["category_onehot"])
    return tuple(args)


def _uncommitted(model: nn.Module) -> Callable[[], None]:
    """Snapshot what a training forward changes in place (the buffers: BN
    running statistics and schedule counts; the dropout generators' states);
    the returned function puts it back."""
    buffers = [(b, b.clone()) for b in model.buffers()]
    gens = {id(m.generator): m.generator for m in model.modules()
            if isinstance(m, Dropout) and m.generator is not None}
    states = [(g, g.get_state()) for g in gens.values()]

    def restore() -> None:
        with torch.no_grad():
            for b, saved in buffers:
                b.copy_(saved)
        for g, state in states:
            g.set_state(state)

    return restore


def make_train_step(
    model: nn.Module,
    optimizer: Optimizer,
    loss_fn: Callable[..., tuple[torch.Tensor, dict]],
) -> Callable[[dict], tuple[torch.Tensor, dict]]:
    """``step(batch) -> (loss, metrics)``, updating the model and optimizer in
    place. ``loss_fn(model_output, batch) -> (loss, metrics)``; ``batch`` holds
    tensors on the model's device. A tile model's metrics carry
    ``tile_overflow``; when it is nonzero the step committed nothing (see the
    module docstring). Otherwise nothing here waits for the device."""
    def step(batch: dict) -> tuple[torch.Tensor, dict]:
        model.train()
        tiles = hasattr(model, "tile_sites") and model.tile_pairs is not None
        if tiles:
            restore = _uncommitted(model)
            out, overflow = model(*_model_args(batch), with_overflow=True)
        else:
            out = model(*_model_args(batch))
        loss, metrics = loss_fn(out, batch)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if tiles:
            metrics["tile_overflow"] = overflow
            if int(overflow) > 0:
                restore()
                return loss.detach(), metrics
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return loss.detach(), metrics

    return step
