"""Classify point-cloud files with the classification zoo (port of
``mccnn_tpu/tasks/predict.py``).

Clouds are read (txt / ply / npz), normalized to the unit cube, resampled to
``--points`` and served in batches of ``--batch`` through
``serve.Predictor``; one JSON line per file gives the label, its probability
and the top 5. ``--model`` picks MCClassS (default), MCClass or MCClassH,
whose joint head is the output (``predict.py:127-131``). Weights come from
``--weights file.npz`` (flat ``params/...`` and ``batch_stats/...`` keys of
the JAX model's variables, read by ``convert.py``) or from ``--init-seed``.
Usage::

    python -m mccnn_tpu_torch.tasks.predict --weights modelnet.npz chair.txt *.ply
    python -m mccnn_tpu_torch.tasks.predict --init-seed 0 --device cpu cloud.npz
    python -m mccnn_tpu_torch.tasks.predict --model MCClassH --device cpu cloud.npz
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..convert import load_flax_variables, load_npz_variables
from ..data.datasets import _normalize_np, pad_points
from ..serve import Predictor
from ..utils import io as pcio
from .modelnet import MODELS, _logits


def read_cloud(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        v = pcio.read_ply(path)
        return np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    if ext == ".npz":
        with np.load(path) as z:
            return np.asarray(z["points"], np.float32)
    return np.asarray(pcio.read_points_txt(path)[:, :3], np.float32)


def classify(logits: np.ndarray) -> dict:
    """label / prob / top5 of one row of logits (``predict.py:138-145``)."""
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    order = np.argsort(probs)[::-1][:5]
    return {
        "label": int(order[0]),
        "prob": float(probs[order[0]]),
        "top5": [[int(c), float(probs[c])] for c in order],
    }


def build_model(args) -> torch.nn.Module:
    kw = {"n_classes": args.n_classes,
          "generator": torch.Generator().manual_seed(args.init_seed)}
    if args.grow:
        kw["grow"] = args.grow
    model = MODELS[args.model](**kw)
    if args.weights:
        load_flax_variables(model, load_npz_variables(args.weights))
    return model.to(args.device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("inputs", nargs="+", help="point-cloud files (txt/ply/npz)")
    p.add_argument("--weights", default=None, help="flat .npz of the JAX variables")
    p.add_argument("--init-seed", type=int, default=0,
                   help="seed of the random weights when --weights is not given")
    p.add_argument("--model", default="MCClassS", choices=sorted(MODELS))
    p.add_argument("--n-classes", type=int, default=40)
    p.add_argument("--grow", type=int, default=None, help="model width (default: the model's)")
    p.add_argument("--points", type=int, default=1024)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="JSONL output (default stdout)")
    p.add_argument("--no-normalize", action="store_true",
                   help="inputs are already in the unit cube")
    p.add_argument("--seed", type=int, default=0, help="resampling seed")
    args = p.parse_args(argv)

    predictor = Predictor(build_model(args), args.batch)
    rng = np.random.default_rng(args.seed)
    records = []
    sink = open(args.out, "w") if args.out else None
    try:
        for start in range(0, len(args.inputs), args.batch):
            files = args.inputs[start : start + args.batch]
            clouds = []
            for f in files:
                pts = read_cloud(f)
                if not args.no_normalize:
                    pts = _normalize_np(pts)
                pts, _, _ = pad_points(pts, args.points, rng)
                clouds.append(pts)
            batch = {
                "points": np.stack(clouds),
                "mask": np.ones((len(clouds), args.points), bool),
            }
            logits = _logits(predictor.predict(batch)).cpu().numpy()
            for i, f in enumerate(files):
                rec = {"file": f, "model": args.model, **classify(logits[i])}
                print(json.dumps(rec), file=sink)
                records.append(rec)
    finally:
        if sink:
            sink.close()
    return records


if __name__ == "__main__":
    main()
