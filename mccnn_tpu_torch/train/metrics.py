"""Structured metrics logging (port of ``mccnn_tpu/train/metrics.py``).

One JSON object per event in ``<directory>/<run_name>.metrics.jsonl``, plus a
mirrored human-readable line on stderr.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any


class MetricsLogger:
    def __init__(self, directory: str | None, run_name: str = "run"):
        self._fh = None
        if directory:
            os.makedirs(directory, exist_ok=True)
            self._fh = open(os.path.join(directory, f"{run_name}.metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, step: int, tag: str = "train", **values: Any) -> None:
        rec = {"t": round(time.time() - self._t0, 3), "step": int(step), "tag": tag}
        rec.update({k: _scalar(v) for k, v in values.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        parts = " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rec.items()
            if k not in ("t", "step", "tag")
        )
        print(f"[{tag}] step {step}: {parts}", file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()


def _scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
