"""ShapeNet part segmentation — train / eval CLI (port of ``mccnn_tpu/tasks/shapenet.py``).

MCSeg with the category one-hot of each cloud joined to every point's input
features (``n_categories`` widens the stem), trained on the per-point
cross-entropy and evaluated as point accuracy, class mIoU (intersection over
union per part, summed over the test set) and instance mIoU (each shape's
mean over the parts present in it). The synthetic source is primitives of
4096 points cut into ``--n-parts`` slabs (4 by default) with a random one of
16 categories; the real one is ShapeNet-part's
``shapenetcore_partanno_segmentation_benchmark_v0`` layout.

Usage::

  python -m mccnn_tpu_torch.tasks.shapenet --synthetic --epochs 2         # on the GPU
  python -m mccnn_tpu_torch.tasks.shapenet --synthetic --device cpu --epochs 1 \\
      --steps-per-epoch 2 --batch 4 --points 64 --grow 8                  # plain path
  python -m mccnn_tpu_torch.tasks.shapenet --data /data/shapenetcore_partanno_segmentation_benchmark_v0
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import datasets, synthetic
from ..models import MCSeg
from ..train import masked_accuracy, segmentation_loss
from .common import Runner, base_parser

N_SYNTHETIC_CATEGORIES = 16  # shapenet.py:86


class SyntheticSegSource:
    """Procedural stand-in with the ``PartSegSource`` protocol (``shapenet.py:23``)."""

    def __init__(self, n_models: int, n_parts: int, n_categories: int, seed: int):
        rng = np.random.default_rng(seed)
        pts, labels = synthetic.segmentation_batch(rng, n_models, 4096, n_parts)
        self._src = datasets.PartSegSource(
            clouds=list(pts),
            point_labels=list(labels),
            categories=rng.integers(0, n_categories, n_models).astype(np.int32),
            n_categories=n_categories,
            n_parts=n_parts,
        )
        self.n_categories = n_categories
        self.n_parts = n_parts
        self.categories = self._src.categories

    def batches(self, *a, **kw):
        return self._src.batches(*a, **kw)


def evaluate(runner: Runner, source, args, rng) -> dict:
    """Point accuracy, class mIoU and instance mIoU over the test set, every
    cloud once (``shapenet.py:42-74``)."""
    n_parts = source.n_parts
    inter = np.zeros(n_parts, np.int64)
    union = np.zeros(n_parts, np.int64)
    correct = total = 0
    per_shape_ious = []
    for batch in source.batches(args.batch, args.points, rng, shuffle=False,
                                drop_remainder=False):
        pred = runner.eval_logits(batch).argmax(-1).cpu().numpy()
        lab, mask = batch["labels"], batch["mask"]
        correct += int(((pred == lab) & mask).sum())
        total += int(mask.sum())
        for b in range(len(pred)):
            ious = []
            for c in np.unique(lab[b][mask[b]]):
                p = (pred[b] == c) & mask[b]
                t = (lab[b] == c) & mask[b]
                i, u = (p & t).sum(), (p | t).sum()
                inter[c] += i
                union[c] += u
                ious.append(i / max(u, 1))
            if ious:
                per_shape_ious.append(float(np.mean(ious)))
    seen = union > 0
    return {
        "point_accuracy": correct / max(total, 1),
        "mIoU_class": float((inter[seen] / np.maximum(union[seen], 1)).mean()),
        "mIoU_instance": float(np.mean(per_shape_ious)) if per_shape_ious else 0.0,
    }


def build_model(n_parts: int, n_categories: int, grow: int | None,
                bn_decay_steps: int | None = None, seed: int = 0) -> MCSeg:
    kw = {"n_classes": n_parts, "n_categories": n_categories,
          "generator": torch.Generator().manual_seed(seed)}
    if grow:
        kw["grow"] = grow
    if bn_decay_steps:
        kw["bn_schedule_steps"] = bn_decay_steps
    return MCSeg(**kw)


def loss_fn(logits, batch):
    return (segmentation_loss(logits, batch["labels"], batch["mask"]),
            {"acc": masked_accuracy(logits, batch["labels"], batch["mask"])})


def main(argv=None):
    p = base_parser("ShapeNet part segmentation (MCSeg)")
    p.add_argument("--n-parts", type=int, default=None)
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    if args.synthetic:
        # size the procedural set so --steps-per-epoch is reachable
        n_train = max(args.batch * 4, args.batch * (args.steps_per_epoch or 0), 64)
        n_parts = args.n_parts or 4
        train_src = SyntheticSegSource(n_train, n_parts, N_SYNTHETIC_CATEGORIES, args.seed)
        test_src = SyntheticSegSource(max(args.batch * 2, 32), n_parts, N_SYNTHETIC_CATEGORIES,
                                      args.seed + 1)
    else:
        train_src = datasets.load_shapenet_part(args.data, "train")
        test_src = datasets.load_shapenet_part(args.data, "test")

    model = build_model(train_src.n_parts, train_src.n_categories, args.grow,
                        args.bn_decay_steps, args.seed)
    example = next(train_src.batches(args.batch, args.points, np.random.default_rng(0)))
    runner = Runner(args, model, loss_fn, "shapenet_mcseg", example)

    if args.eval_only:
        res = evaluate(runner, test_src, args, rng)
        runner.metrics.log(runner.state.step, tag="eval", **res)
        runner.close()
        return res

    best = 0.0
    for epoch in range(runner.start_epoch, args.epochs):
        batches = train_src.batches(args.batch, args.points, rng, train_augment=True,
                                    protocol=args.protocol)
        runner.train_epoch(batches, epoch)
        if (epoch + 1) % args.eval_every == 0:
            res = evaluate(runner, test_src, args, rng)
            runner.metrics.log(runner.state.step, tag="eval", epoch=epoch, **res)
            if res["mIoU_instance"] >= best:
                best = res["mIoU_instance"]
                runner.save(epoch + 1)
    runner.metrics.log(runner.state.step, tag="final", best_mIoU=best)
    runner.close()
    return {"best_mIoU": best}


if __name__ == "__main__":
    main()
