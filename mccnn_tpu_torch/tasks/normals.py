"""Per-point normal estimation — train / eval CLI (port of ``mccnn_tpu/tasks/normals.py``).

MCNorm or MCNormS regresses a 3-vector per point, trained on the
sign-invariant cosine loss (``train.normal_loss``) against ground-truth
normals and evaluated as the mean angular error in degrees. The synthetic
source is spheres of 4096 points with their analytic normals, drawn down to
``--points``; the real one is ModelNet40's resampled clouds, whose files carry
normals.

Usage::

  python -m mccnn_tpu_torch.tasks.normals --synthetic --epochs 2          # on the GPU
  python -m mccnn_tpu_torch.tasks.normals --synthetic --device cpu --epochs 1 \\
      --steps-per-epoch 2 --batch 4 --points 64 --grow 8                  # plain path
  python -m mccnn_tpu_torch.tasks.normals --model MCNormS --data /data/modelnet40_normal_resampled
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import datasets, synthetic
from ..data.sampling_protocols import draw
from ..models import MCNorm, MCNormS
from ..train import normal_loss
from .common import Runner, base_parser

MODELS = {"MCNorm": MCNorm, "MCNormS": MCNormS}


class NormalsSource:
    """Clouds and their per-point normals, batched with the normals of the
    drawn points as the target (``normals.py:25-97``, its numpy branch: the
    reference's default native host pipe is still to port)."""

    def __init__(self, clouds: list, normals: list):
        self.clouds = clouds
        self.normals = normals

    @classmethod
    def synthetic(cls, n_models: int, seed: int) -> "NormalsSource":
        rng = np.random.default_rng(seed)
        pts, nrm = synthetic.normals_batch(rng, n_models, 4096)
        return cls(list(pts), list(nrm))

    @classmethod
    def from_modelnet(cls, root: str, split: str) -> "NormalsSource":
        src = datasets.load_modelnet40(root, split)
        keep = [i for i, n in enumerate(src.normals) if n is not None]
        return cls([src.clouds[i] for i in keep], [src.normals[i] for i in keep])

    def batches(self, batch_size: int, n_points: int, rng: np.random.Generator, *,
                shuffle: bool = True, protocol: str = "uniform", drop_remainder: bool = True):
        """``points``, ``mask`` and ``normals (B, N, 3)``; no augmentation on
        this task, as in the reference."""
        order = np.arange(len(self.clouds))
        if shuffle:
            rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            chunk = order[start : start + batch_size]
            if len(chunk) < batch_size and drop_remainder:
                return
            pts_b, nrm_b = [], []
            for i in chunk:
                idx = draw(protocol, self.clouds[i], n_points, rng, normals=self.normals[i])
                pts_b.append(datasets._normalize_np(self.clouds[i][idx]))
                nrm_b.append(self.normals[i][idx])
            yield {
                "points": np.stack(pts_b),
                "mask": np.ones((len(chunk), n_points), bool),
                "normals": np.stack(nrm_b).astype(np.float32),
            }


def angular_error_deg(pred: np.ndarray, target: np.ndarray, mask: np.ndarray) -> float:
    """Mean unoriented angle between predicted and true normals over the
    valid points, in degrees (norms floored at 1e-8, ``normals.py:100-105``)."""
    p = pred / np.maximum(np.linalg.norm(pred, axis=-1, keepdims=True), 1e-8)
    t = target / np.maximum(np.linalg.norm(target, axis=-1, keepdims=True), 1e-8)
    cos = np.abs((p * t).sum(-1)).clip(0, 1)
    return float(np.degrees(np.arccos(cos))[mask].mean())


def evaluate(runner: Runner, source: NormalsSource, args, rng) -> dict:
    """The mean over batches of each batch's angular error (every cloud, the
    last batch ragged)."""
    errs = []
    for batch in source.batches(args.batch, args.points, rng, shuffle=False,
                                drop_remainder=False):
        pred = runner.eval_logits(batch).cpu().numpy()
        errs.append(angular_error_deg(pred, batch["normals"], batch["mask"]))
    return {"angular_error_deg": float(np.mean(errs))}


def build_model(name: str, grow: int | None, bn_decay_steps: int | None = None,
                seed: int = 0) -> torch.nn.Module:
    kw = {"generator": torch.Generator().manual_seed(seed)}
    if grow:
        kw["grow"] = grow
    if bn_decay_steps:
        kw["bn_schedule_steps"] = bn_decay_steps
    return MODELS[name](**kw)


def loss_fn(pred, batch):
    return normal_loss(pred, batch["normals"], batch["mask"]), {}


def main(argv=None):
    p = base_parser("Per-point normal estimation (MCNorm / MCNormS)")
    p.add_argument("--model", default="MCNorm", choices=sorted(MODELS))
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    if args.synthetic:
        # size the procedural set so --steps-per-epoch is reachable
        n_train = max(args.batch * 4, args.batch * (args.steps_per_epoch or 0), 64)
        train_src = NormalsSource.synthetic(n_train, args.seed)
        test_src = NormalsSource.synthetic(max(args.batch * 2, 32), args.seed + 1)
    else:
        train_src = NormalsSource.from_modelnet(args.data, "train")
        test_src = NormalsSource.from_modelnet(args.data, "test")

    model = build_model(args.model, args.grow, args.bn_decay_steps, args.seed)
    example = next(train_src.batches(args.batch, args.points, np.random.default_rng(0)))
    runner = Runner(args, model, loss_fn, f"normals_{args.model}", example)

    if args.eval_only:
        res = evaluate(runner, test_src, args, rng)
        runner.metrics.log(runner.state.step, tag="eval", **res)
        runner.close()
        return res

    best = float("inf")
    for epoch in range(runner.start_epoch, args.epochs):
        batches = train_src.batches(args.batch, args.points, rng, protocol=args.protocol)
        runner.train_epoch(batches, epoch)
        if (epoch + 1) % args.eval_every == 0:
            res = evaluate(runner, test_src, args, rng)
            runner.metrics.log(runner.state.step, tag="eval", epoch=epoch, **res)
            if res["angular_error_deg"] <= best:
                best = res["angular_error_deg"]
                runner.save(epoch + 1)
    runner.metrics.log(runner.state.step, tag="final", best_angular_error=best)
    runner.close()
    return {"best_angular_error": best}


if __name__ == "__main__":
    main()
