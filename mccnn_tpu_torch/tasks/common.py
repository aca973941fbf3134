"""Shared task plumbing: the argument parser, the train / eval loops with
checkpoints and JSONL metrics (port of ``mccnn_tpu/tasks/common.py``).

One device: ``--device`` (default ``cuda``) names it, and a CUDA device that
is missing raises rather than falling back to the CPU. The reference's mesh
(``common.py:197-212``) comes with the distribution slice.

Tile capacities (``:88-179``): a model with a ``tile_pairs`` knob left unset
gets it sized from the example batch when that batch is big-scene scale
(``maybe_auto_tile_pairs``), and per-site step budgets measured on the same
batch (``auto_tile_steps``). Training and evaluation recover from overflow as
the reference does (``:345-381``, ``:405-423``): a batch that drops steps
grows the budgets to cover it and runs again, up to three times
(``_resize_tile_capacity``); a training step that dropped any committed
nothing (``train/state.py``), so it runs again from the same state.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import time
from typing import Callable, Iterator

import numpy as np
import torch

from ..api.hierarchy import build_hierarchy
from ..core.sampling import count_poisson_sweep_steps
from ..ops.cuda.tile_conv import auto_tile_pairs, count_tile_steps
from ..ops.dispatch import DENSE_MAX_N
from ..train import batch_to_device, init_state, make_optimizer, make_train_step
from ..train.checkpoint import Checkpointer
from ..train.state import _model_args
from ..train.metrics import MetricsLogger


def base_parser(description: str) -> argparse.ArgumentParser:
    """The reference's flags (``common.py:26-85``) plus ``--device``, less
    ``--pt-drop-max``: only classification reads it, so ``tasks/modelnet.py``
    adds it (the reference's shared flag is silently ignored elsewhere)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--data", type=str, default=None, help="dataset root")
    p.add_argument("--synthetic", action="store_true", help="procedural data")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--points", type=int, default=1024)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr-decay-steps", type=int, default=20000)
    p.add_argument("--lr-decay-rate", type=float, default=0.7)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--grad-clip", type=float, default=None)
    p.add_argument("--grow", type=int, default=None, help="model width knob")
    p.add_argument(
        "--bn-decay-steps", type=int, default=None,
        help="enable the reference's BN decaying-momentum schedule (0.5 -> 0.99 "
        "over this many steps); default: fixed momentum 0.9",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", type=str, default=None)
    p.add_argument("--log-dir", type=str, default="logs")
    p.add_argument("--run-name", type=str, default=None)
    p.add_argument("--eval-every", type=int, default=1, help="epochs")
    p.add_argument("--resume", action="store_true")
    p.add_argument(
        "--protocol", type=str, default="uniform",
        choices=("uniform", "gradient", "split", "lambert", "occlusion"),
        help="non-uniform sampling protocol (robustness experiments)",
    )
    p.add_argument("--eval-only", action="store_true")
    p.add_argument(
        "--profile-dir", type=str, default=None,
        help="trace the second epoch of this run with torch.profiler into this "
        "directory: a chrome trace and a table of time by operator and kernel",
    )
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on (cuda, or cpu for the plain path)")
    return p


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device; pass --device cpu to run "
                           "the plain PyTorch path on the CPU")
    return device


def _level0_radius(model) -> float:
    """The largest level-0 conv radius: it bounds every other site's demand."""
    return float(model.radii[0]) * float(getattr(model, "conv_radius_scale", 2.0))


@torch.no_grad()
def maybe_auto_tile_pairs(model, example_batch: dict, device: torch.device):
    """Size an unset ``tile_pairs`` knob from ``example_batch`` (in place)
    when the batch is big-scene scale (``common.py:88``), then the per-site
    step budgets when ``tile_steps`` is unset. A model without the knob, or a
    batch within the dense bound, is left alone."""
    if getattr(model, "tile_pairs", False) is False:
        return model
    pts = np.asarray(example_batch["points"])
    if pts.shape[1] <= DENSE_MAX_N:
        return model
    pts_t = torch.from_numpy(pts).to(device)
    mask_t = torch.from_numpy(np.asarray(example_batch["mask"])).to(device)
    if model.tile_pairs is None:
        radius = _level0_radius(model)
        model.tile_pairs = auto_tile_pairs(pts_t, mask_t, radius)
        print(f"# auto tile_pairs = {model.tile_pairs} (N={pts.shape[1]}, r0={radius})")
    if getattr(model, "tile_steps", False) is None and hasattr(model, "tile_sites"):
        model.tile_steps = auto_tile_steps(model, pts_t, mask_t)
        print(f"# auto tile_steps = {model.tile_steps}")
    return model


@torch.no_grad()
def auto_tile_steps(model, pts: torch.Tensor, mask: torch.Tensor,
                    headroom: float = 1.3) -> dict:
    """Measured per-site step budgets for ``model.tile_sites()`` (``common.py:134``):
    the hierarchy is built once on ``pts``, each site's exact demand is
    counted, times ``headroom``, rounded up to 16."""
    h = build_hierarchy(pts, mask, tuple(float(r) for r in model.radii), global_level=False,
                        tile_pairs=model.tile_pairs)
    budgets = {}
    for site in model.tile_sites(len(h.levels)):
        if site[0] == "conv":
            _, in_lvl, out_lvl, r = site
            dst, src = h.levels[out_lvl], h.levels[in_lvl]
            counts = count_tile_steps(dst.points, dst.mask, src.points, src.mask, float(r))
        elif site[0] == "sweep":
            _, lvl, r = site
            src = h.levels[lvl]
            counts = count_poisson_sweep_steps(src.points, src.mask, float(r))
        else:  # kde: the source level against itself
            _, lvl, r = site
            src = h.levels[lvl]
            counts = count_tile_steps(src.points, src.mask, src.points, src.mask, float(r))
        need = int(counts.max())
        budgets[site] = -(-int(need * headroom + 1) // 16) * 16
    return budgets


class Runner:
    """Owns the train state, the train step, checkpoints and the epoch loop.

    ``example_batch`` (numpy, optional) sizes a big-scene model's tile
    capacities (``maybe_auto_tile_pairs``)."""

    def __init__(self, args, model: torch.nn.Module, loss_fn: Callable, run_name: str,
                 example_batch: dict | None = None):
        self.args = args
        self.device = resolve_device(args.device)
        self.model = model.to(self.device)
        if example_batch is not None:
            maybe_auto_tile_pairs(self.model, example_batch, self.device)
        self.optimizer = make_optimizer(
            self.model.parameters(),
            lr=args.lr,
            decay_steps=args.lr_decay_steps,
            decay_rate=args.lr_decay_rate,
            weight_decay=args.weight_decay,
            grad_clip=args.grad_clip,
        )
        self.state = init_state(self.model, self.optimizer, args.seed)
        self._train_step = make_train_step(self.model, self.optimizer, loss_fn)

        name = args.run_name or run_name
        self.metrics = MetricsLogger(args.log_dir, name)
        self.ckpt = Checkpointer(args.ckpt_dir or f"ckpts/{name}")
        self.start_epoch = 0
        if args.resume or args.eval_only:
            extra = self.ckpt.restore(self.state)
            self.start_epoch = int(extra.get("epoch", 0))

        # Preemption safety: on SIGTERM/SIGINT checkpoint the current state
        # before exiting, so --resume continues from it.
        self._epoch = self.start_epoch
        self._install_signal_handlers()

    def _install_signal_handlers(self) -> None:
        def handler(signum, frame):
            try:
                self.save(self._epoch)
                self.metrics.log(self.state.step, tag="preempt", signal=int(signum))
            finally:
                raise SystemExit(128 + signum)

        self._previous_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._previous_handlers[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread
                pass

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_epoch(self, batches: Iterator[dict], epoch: int) -> dict:
        """Train over ``batches`` (at most ``--steps-per-epoch``); logs and
        returns the mean loss and metrics, the steps, the seconds, the
        capacity re-sizes (``capacity_resizes``, when any) and, with two or
        more steps, ``warm_step_ms``: the mean step time after the first (host
        clock between two device synchronisations).

        A step whose tile kernels dropped steps (``tile_overflow`` > 0) was
        not committed: the budgets grow to cover its batch and it runs again,
        at most three times (``common.py:345-381``)."""
        self._epoch = epoch
        losses, sums = [], {}
        resizes = 0
        profiling = self.args.profile_dir and epoch == self.start_epoch + 1
        with contextlib.ExitStack() as stack:
            prof = stack.enter_context(self._profiler()) if profiling else None
            t0, t_first, n = time.perf_counter(), None, 0
            for batch in batches:
                dev_batch = batch_to_device(batch, self.device)

                def step():
                    loss, metrics = self._train_step(dev_batch)
                    return (loss, metrics), metrics.get("tile_overflow")

                (loss, metrics), attempts = self._rerun_until_fits(step, dev_batch, "train")
                resizes += attempts
                losses.append(loss)
                for k, v in metrics.items():
                    sums.setdefault(k, []).append(v)
                n += 1
                if n == 1:
                    self._sync()
                    t_first = time.perf_counter()
                if self.args.steps_per_epoch and n >= self.args.steps_per_epoch:
                    break
            self._sync()
            t_end = time.perf_counter()
        out = {
            "loss": float(torch.stack(losses).mean()),
            "steps": n,
            "sec": round(t_end - t0, 2),
        }
        if resizes:
            out["capacity_resizes"] = resizes
        if n > 1:
            out["warm_step_ms"] = (t_end - t_first) * 1e3 / (n - 1)
        for k, vs in sums.items():
            out[k] = float(torch.stack(vs).float().mean())
        if prof is not None:
            out.update(self._write_profile(prof, (t_end - t0) * 1e3))
        self.metrics.log(self.state.step, tag="train", epoch=epoch, **out)
        return out

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def _write_profile(self, prof, wall_ms: float) -> dict:
        """The chrome trace and a table by operator / kernel into
        ``--profile-dir``; returns the device's kernel time over the epoch
        and its share of the epoch's wall time (CUDA only)."""
        from torch.autograd import DeviceType

        os.makedirs(self.args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.args.profile_dir, "trace.json"))
        events = prof.key_averages()
        cuda = self.device.type == "cuda"
        with open(os.path.join(self.args.profile_dir, "ops.txt"), "w") as f:
            f.write(f"epoch wall time {wall_ms:.3f} ms\n")
            for key in (["self_cuda_time_total"] if cuda else []) + ["self_cpu_time_total"]:
                f.write(f"by {key}\n{events.table(sort_by=key, row_limit=40)}\n")
        if not cuda:
            return {}
        # kernels and copies only: an operator's row, and a range annotated on
        # the device (the optimizer's step), repeats its kernels' time
        device = [e for e in events
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        device_ms = sum(e.self_device_time_total for e in device) / 1e3
        return {"profile_device_ms": device_ms, "profile_busy_share": device_ms / wall_ms,
                "profile_device_events": sum(e.count for e in device)}

    def eval_logits(self, batch: dict) -> torch.Tensor | tuple[torch.Tensor, ...]:
        """Eval-mode logits of one batch, as given: the reference pads a ragged
        batch to ``--batch`` for one compiled shape (``common.py:322-343``);
        eager PyTorch needs none, and in eval mode no cloud's result depends
        on another's. A model that returns a tuple (MCClassH's ``(joint, a,
        b)``) gives the tuple; the task picks its logits.

        A model with tile sites reports its dropped steps; a batch that drops
        any grows the budgets to cover it and runs again (``common.py:405-423``)."""
        args = batch_to_device(batch, self.device)
        inputs = _model_args(args)
        self.model.eval()
        with torch.inference_mode():
            if not hasattr(self.model, "tile_sites"):
                return self.model(*inputs)
            out, _ = self._rerun_until_fits(
                lambda: self.model(*inputs, with_overflow=True), args, "eval")
        return out

    def _rerun_until_fits(self, run, batch: dict, phase: str) -> tuple:
        """``run()`` -> (result, dropped tile steps or None); while it drops
        steps, grow the budgets to cover ``batch``, log a ``resize`` record and
        run it again, at most three times (``common.py:352-381``, ``:405-423``).
        Returns the result and the number of re-sizes."""
        result, ovf = run()
        attempts = 0
        while ovf is not None and (dropped := float(ovf)) > 0:
            if attempts >= 3:
                raise RuntimeError(
                    f"tile capacity overflow persists in {phase} after {attempts} re-sizes "
                    f"({dropped:.0f} dropped steps): auto_tile_pairs cannot cover this batch; "
                    "raise tile_pairs manually"
                )
            attempts += 1
            event = self._resize_tile_capacity(batch)
            extra = {"phase": phase} if phase != "train" else {}
            self.metrics.log(self.state.step, tag="resize", tile_overflow=dropped,
                             attempt=attempts, **extra, **event)
            result, ovf = run()
        return result, attempts

    def _resize_tile_capacity(self, batch: dict) -> dict:
        """Grow the model's tile budgets to cover ``batch`` (``common.py:265``):
        each only ever grows, so earlier batches cannot overflow again."""
        model = self.model
        pts, mask = batch["points"], batch["mask"]
        old_pairs = model.tile_pairs or 0
        model.tile_pairs = max(old_pairs, auto_tile_pairs(pts, mask, _level0_radius(model)))
        event = {"tile_pairs": model.tile_pairs, "tile_pairs_old": old_pairs}
        if model.tile_steps is not None:
            old = dict(model.tile_steps)
            fresh = auto_tile_steps(model, pts, mask)
            model.tile_steps = {k: max(old.get(k, 0), fresh.get(k, 0))
                                for k in set(old) | set(fresh)}
            event["tile_steps"] = {str(k): v for k, v in model.tile_steps.items()}
        return event

    def save(self, epoch: int) -> None:
        self.ckpt.save(self.state, extra={"epoch": epoch})

    def close(self) -> None:
        for sig, previous in self._previous_handlers.items():
            signal.signal(sig, previous)
        self.metrics.close()
        self.ckpt.close()
