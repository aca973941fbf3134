"""Checkpoint / resume (port of ``mccnn_tpu/train/checkpoint.py:21-61``).

Where the reference writes the full train state through orbax, this is a
``torch.save`` of the module's state (parameters and BN statistics), the
optimizer (Adam's moments, the step count), the dropout generator's state and
``extra`` (the epoch), one file per step, keeping the newest ``max_to_keep``.
"""

from __future__ import annotations

import os
import re

import torch

from .state import TrainState

_NAME = re.compile(r"ckpt_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list[int]:
        return sorted(int(m.group(1)) for n in os.listdir(self.directory)
                      if (m := _NAME.fullmatch(n)))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def save(self, state: TrainState, extra: dict | None = None) -> None:
        payload = {
            "step": state.step,
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "generator": state.generator.get_state(),
            "extra": extra or {"epoch": 0},
        }
        path = self._path(state.step)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self._steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState) -> dict:
        """Load the latest checkpoint into ``state`` in place; returns its
        ``extra`` ({} when there is none)."""
        step = self.latest_step()
        if step is None:
            return {}
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.generator.set_state(payload["generator"])
        if state.step != payload["step"]:
            raise ValueError(f"checkpoint {step}: optimizer count {state.step} != step "
                             f"{payload['step']}")
        return payload["extra"]

    def close(self) -> None:
        pass
