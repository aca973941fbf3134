"""Shared task plumbing: the argument parser, the train / eval loops with
checkpoints and JSONL metrics (port of ``mccnn_tpu/tasks/common.py``).

One device: ``--device`` (default ``cuda``) names it, and a CUDA device that
is missing raises rather than falling back to the CPU. The reference's mesh
(``common.py:197-212``) and its tile-capacity sizing and resize
(``:88-179``, ``:265-299``, ``:356-381``) are not here: they come with the
big-scene and distribution slices, and MCClassS at N = 1024 never reaches
them.
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

from ..train import batch_to_device, init_state, make_optimizer, make_train_step
from ..train.checkpoint import Checkpointer
from ..train.metrics import MetricsLogger


def base_parser(description: str) -> argparse.ArgumentParser:
    """The reference's flags (``common.py:26-85``) plus ``--device``."""
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
        "--pt-drop-max", type=float, default=0.0,
        help="train-time point-dropout augmentation: per-cloud drop ratio drawn "
        "from U(0, this) (the reference's ptDropOut)",
    )
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


class Runner:
    """Owns the train state, the train step, checkpoints and the epoch loop."""

    def __init__(self, args, model: torch.nn.Module, loss_fn: Callable, run_name: str):
        self.args = args
        self.device = resolve_device(args.device)
        self.model = model.to(self.device)
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

    def _pad_eval_batch(self, batch: dict) -> tuple[dict, int]:
        """Pad a ragged final eval batch up to ``--batch`` by repeating its
        first row (``common.py:322-343`` on one device: one eval shape). The
        caller slices the outputs back to the returned true size."""
        b = next(iter(batch.values())).shape[0]
        full = getattr(self.args, "batch", b)
        if b >= full:
            return batch, b
        pad = full - b
        padded = {
            k: np.concatenate([v, np.repeat(np.asarray(v)[:1], pad, axis=0)])
            for k, v in batch.items()
        }
        return padded, b

    def train_epoch(self, batches: Iterator[dict], epoch: int) -> dict:
        """Train over ``batches`` (at most ``--steps-per-epoch``); logs and
        returns the mean loss and metrics, the steps, the seconds and, with two
        or more steps, ``warm_step_ms``: the mean step time after the first
        (host clock between two device synchronisations)."""
        self._epoch = epoch
        losses, sums = [], {}
        profiling = self.args.profile_dir and epoch == self.start_epoch + 1
        with contextlib.ExitStack() as stack:
            prof = stack.enter_context(self._profiler()) if profiling else None
            t0, t_first, n = time.perf_counter(), None, 0
            for batch in batches:
                loss, metrics = self._train_step(batch_to_device(batch, self.device))
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
        if n > 1:
            out["warm_step_ms"] = (t_end - t_first) * 1e3 / (n - 1)
        for k, vs in sums.items():
            out[k] = float(torch.stack(vs).mean())
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

    def eval_logits(self, batch: dict) -> torch.Tensor:
        """Eval-mode logits of one batch (padded to ``--batch`` and sliced back)."""
        padded, b = self._pad_eval_batch(batch)
        args = batch_to_device(padded, self.device)
        self.model.eval()
        with torch.inference_mode():
            out = self.model(args["points"], args["mask"], args.get("features"))
        return out[:b]

    def save(self, epoch: int) -> None:
        self.ckpt.save(self.state, extra={"epoch": epoch})

    def close(self) -> None:
        for sig, previous in self._previous_handlers.items():
            signal.signal(sig, previous)
        self.metrics.close()
        self.ckpt.close()
