"""ModelNet40 classification — train / eval CLI (port of ``mccnn_tpu/tasks/modelnet.py``).

Model selection (MCClassS, MCClass, MCClassH), Adam with staircase decay,
augmentation (rotation, jitter, scaling, point dropout), non-uniform sampling
protocols, periodic eval with voting (``k`` fresh resamplings per model,
averaged logits) and checkpoints. MCClassH trains on its joint + per-path
loss; its accuracy and voting take the joint head's logits.

Usage::

  python -m mccnn_tpu_torch.tasks.modelnet --synthetic --epochs 2        # on the GPU
  python -m mccnn_tpu_torch.tasks.modelnet --synthetic --device cpu --epochs 1 \\
      --steps-per-epoch 2 --batch 2 --points 128 --grow 8                 # plain path
  python -m mccnn_tpu_torch.tasks.modelnet --synthetic --model MCClassH --protocol gradient
  python -m mccnn_tpu_torch.tasks.modelnet --data /data/modelnet40_normal_resampled
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import datasets, synthetic
from ..models import MCClass, MCClassH, MCClassS
from ..train import accuracy, classh_loss, classification_loss
from .common import Runner, base_parser

MODELS = {"MCClassS": MCClassS, "MCClass": MCClass, "MCClassH": MCClassH}


def build_model(name: str, n_classes: int, grow: int | None,
                bn_decay_steps: int | None = None, seed: int = 0) -> torch.nn.Module:
    kw = {"n_classes": n_classes, "generator": torch.Generator().manual_seed(seed)}
    if grow:
        kw["grow"] = grow
    if bn_decay_steps:
        kw["bn_schedule_steps"] = bn_decay_steps
    return MODELS[name](**kw)


def make_loss(name: str):
    if name == "MCClassH":

        def loss_fn(out, batch):
            return classh_loss(out, batch["labels"]), {"acc": accuracy(out[0], batch["labels"])}

    else:

        def loss_fn(out, batch):
            return classification_loss(out, batch["labels"]), {
                "acc": accuracy(out, batch["labels"])
            }

    return loss_fn


def _logits(out):
    """The deployment logits: MCClassH's joint head (``modelnet.py:58-59``)."""
    return out[0] if isinstance(out, tuple) else out


class SyntheticSource:
    """Procedural stand-in exposing the ClassificationSource protocol."""

    def __init__(self, n_models: int, n_classes: int, seed: int):
        rng = np.random.default_rng(seed)
        self.class_names = [f"class_{i}" for i in range(n_classes)]
        pts, labels = synthetic.classification_batch(rng, n_models, 4096, n_classes)
        self.clouds = [p for p in pts]
        self.normals = [None] * n_models
        self.labels = labels
        self._src = datasets.ClassificationSource(
            self.clouds, self.normals, self.labels, self.class_names
        )

    def batches(self, *a, **kw):
        return self._src.batches(*a, **kw)


def evaluate(runner: Runner, source, args, votes: int, rng) -> dict:
    """Voting eval: average logits over ``votes`` fresh resamplings."""
    n = len(source.labels)
    sum_logits = None
    labels_ref = None
    for _ in range(votes):
        logits_parts, labels_parts = [], []
        vote_rng = np.random.default_rng(rng.integers(1 << 31))
        for batch in source.batches(
            args.batch,
            args.points,
            vote_rng,
            shuffle=False,
            train_augment=False,
            protocol=args.protocol,
            drop_remainder=False,
        ):
            logits_parts.append(_logits(runner.eval_logits(batch)).cpu().numpy())
            labels_parts.append(batch["labels"])
        logits = np.concatenate(logits_parts)[:n]
        labels_ref = np.concatenate(labels_parts)[:n]
        sum_logits = logits if sum_logits is None else sum_logits + logits
    acc = float((sum_logits.argmax(-1) == labels_ref).mean())
    per_class = {}
    for c in np.unique(labels_ref):
        m = labels_ref == c
        per_class[int(c)] = float((sum_logits[m].argmax(-1) == c).mean())
    return {"accuracy": acc, "mean_class_accuracy": float(np.mean(list(per_class.values())))}


def main(argv=None):
    p = base_parser("ModelNet40 classification (MCClassS / MCClass / MCClassH)")
    p.add_argument("--model", default="MCClassS", choices=sorted(MODELS))
    p.add_argument("--votes", type=int, default=1, help="eval voting rounds")
    p.add_argument("--n-classes", type=int, default=None)
    # classification trains with ptDropOut on by default (reference DataSet)
    p.add_argument(
        "--pt-drop-max", type=float, default=0.3,
        help="train-time point-dropout augmentation: per-cloud drop ratio drawn "
        "from U(0, this) (the reference's ptDropOut)",
    )
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    if args.synthetic:
        n_classes = args.n_classes or 6
        # size the procedural set so --steps-per-epoch is reachable
        n_train = max(args.batch * 4, args.batch * (args.steps_per_epoch or 0), 64)
        train_src = SyntheticSource(n_train, n_classes, args.seed)
        test_src = SyntheticSource(max(args.batch * 2, 32), n_classes, args.seed + 1)
    else:
        train_src = datasets.load_modelnet40(args.data, "train")
        test_src = datasets.load_modelnet40(args.data, "test")
        n_classes = len(train_src.class_names)

    model = build_model(args.model, n_classes, args.grow, args.bn_decay_steps, args.seed)
    runner = Runner(args, model, make_loss(args.model), f"modelnet_{args.model}")

    if args.eval_only:
        res = evaluate(runner, test_src, args, args.votes, rng)
        runner.metrics.log(runner.state.step, tag="eval", **res)
        runner.close()
        return res

    best = 0.0
    for epoch in range(runner.start_epoch, args.epochs):
        batches = train_src.batches(
            args.batch,
            args.points,
            rng,
            train_augment=True,
            protocol=args.protocol,
            pt_drop_max=args.pt_drop_max,
        )
        runner.train_epoch(batches, epoch)
        if (epoch + 1) % args.eval_every == 0:
            res = evaluate(runner, test_src, args, args.votes, rng)
            runner.metrics.log(runner.state.step, tag="eval", epoch=epoch, **res)
            if res["accuracy"] >= best:
                best = res["accuracy"]
                runner.save(epoch + 1)
    runner.metrics.log(runner.state.step, tag="final", best_accuracy=best)
    runner.close()
    return {"best_accuracy": best}


if __name__ == "__main__":
    main()
