"""ScanNet semantic segmentation with MCSeg — train / eval CLI (port of
``mccnn_tpu/tasks/scannet.py``).

Two ways to evaluate, as in the reference:

* blocks (the reference's protocol): batches of ``--batch`` random xy
  columns of ``--block-size``, each resampled to ``--points`` points;
* whole scenes (``--whole-scene-cap``): each test scene in one forward pass
  at B = 1, padded to the cap.

At ``--points`` beyond the dense bound the tile capacity is sized from the
first batch, so the big levels take the z-order tile kernels (K5, K7, K8 and,
in training, K6 for the tile convs' backward); a denser batch re-sizes it, in
training and in evaluation (``tasks/common.py``). Training runs the model
through ``Runner.train_epoch``, on the card or, with ``--device cpu``, on the
plain PyTorch path. ``--tile-pairs 0`` means "no capacity given", as in the
reference's CLI: the Runner then sizes one from the first batch. (The
capacity-free bucket path, K9 / K10, is for direct users of
``MCSeg(tile_pairs=None)``; this CLI never takes it, as the reference's does
not.) Not ported (it raises): the spatially sharded trainer
(``--spatial-shards`` / ``--data-shards`` > 1).

Usage::

  python -m mccnn_tpu_torch.tasks.scannet --synthetic                        # train, GPU
  python -m mccnn_tpu_torch.tasks.scannet --synthetic --device cpu --batch 2 \\
      --points 1100 --grow 8 --radii 0.4,0.8 --epochs 1 --steps-per-epoch 2  # tiny, CPU

  python -m mccnn_tpu_torch.tasks.scannet --synthetic --eval-only            # blocks, GPU
  python -m mccnn_tpu_torch.tasks.scannet --synthetic --eval-only \\
      --whole-scene-cap 40960                                                # whole scenes
  python -m mccnn_tpu_torch.tasks.scannet --data /data/scannet --eval-only   # scannet_*.npz
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data import datasets
from ..data.datasets import _normalize_np, pad_points
from ..models import MCSeg
from ..train import masked_accuracy, segmentation_loss
from .common import Runner, base_parser


class SyntheticSceneSource:
    """Room-like procedural scenes of 20k-40k points (``scannet.py:24``):
    uniform in a 6 x 6 x 1 box, labelled by height band."""

    def __init__(self, n_scenes: int, n_classes: int, seed: int):
        rng = np.random.default_rng(seed)
        scenes, labels = [], []
        for _ in range(n_scenes):
            n = rng.integers(20000, 40000)
            pts = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
            pts[:, :2] *= 6.0  # room-like xy extent, unit height
            lab = np.digitize(pts[:, 2], np.linspace(0, 1, n_classes + 1)[1:-1]).astype(np.int32)
            scenes.append(pts)
            labels.append(lab)
        self._src = datasets.SceneSegSource(scenes, labels, n_classes)
        self.n_classes = n_classes
        self.labels = labels

    def batches(self, *a, **kw):
        return self._src.batches(*a, **kw)


class _IoU:
    """Point accuracy and mIoU over the classes seen (``scannet.py:45-71``)."""

    def __init__(self, n_classes: int):
        self.inter = np.zeros(n_classes, np.int64)
        self.union = np.zeros(n_classes, np.int64)
        self.correct = self.total = 0

    def add(self, pred, lab, mask):
        self.correct += int(((pred == lab) & mask).sum())
        self.total += int(mask.sum())
        for c in range(len(self.inter)):
            p, t = (pred == c) & mask, (lab == c) & mask
            self.inter[c] += int((p & t).sum())
            self.union[c] += int((p | t).sum())

    def result(self) -> dict:
        seen = self.union > 0
        return {"point_accuracy": self.correct / max(self.total, 1),
                "mIoU": float((self.inter[seen] / np.maximum(self.union[seen], 1)).mean())}


def _sync(runner: Runner) -> None:
    if runner.device.type == "cuda":
        torch.cuda.synchronize(runner.device)


def evaluate(runner: Runner, source, args, rng, n_classes: int) -> dict:
    """Block evaluation: ``--batch * 8`` blocks; also the mean latency of a
    batch (host clock to a device synchronisation) as ``batch_ms``."""
    iou = _IoU(n_classes)
    times = []
    for batch in source.batches(args.batch, args.points, rng, shuffle=False,
                                drop_remainder=False, blocks_per_epoch=args.batch * 8):
        t0 = time.perf_counter()
        logits = runner.eval_logits(batch)
        _sync(runner)
        times.append(time.perf_counter() - t0)
        iou.add(logits.argmax(-1).cpu().numpy(), batch["labels"], batch["mask"])
    return {**iou.result(), "batches": len(times), "batch_ms": 1e3 * float(np.mean(times)),
            "batch_ms_all": [1e3 * t for t in times]}


def predict_scene_tile(runner: Runner, scene: np.ndarray, cap: int) -> np.ndarray:
    """The whole scene through MCSeg in one forward pass at B = 1, padded to
    ``cap`` points (``scannet.py:74``); per-point predicted classes. The
    reference also pads the batch to ``--batch`` copies of the scene (one
    compiled shape under jit); eager PyTorch needs no such padding."""
    n = len(scene)
    if n > cap:
        raise ValueError(f"scene has {n} points > whole-scene capacity {cap}")
    pts = np.zeros((cap, 3), np.float32)
    pts[:n] = _normalize_np(scene)
    mask = np.arange(cap) < n
    out = runner.eval_logits({"points": pts[None], "mask": mask[None]})
    return out[0, :n].argmax(-1).cpu().numpy()


def evaluate_whole_scenes(runner: Runner, source, cap: int, n_classes: int) -> dict:
    """Accuracy and mIoU over full scenes, one pass each (``scannet.py:99``),
    and the latency of each scene (host clock to a device synchronisation)."""
    src = getattr(source, "_src", source)
    iou = _IoU(n_classes)
    times = []
    for scene, lab in zip(src.scenes, src.labels):
        t0 = time.perf_counter()
        pred = predict_scene_tile(runner, scene, cap)
        _sync(runner)
        times.append(time.perf_counter() - t0)
        iou.add(pred, lab, np.ones(len(lab), bool))
    return {**iou.result(), "scenes": len(times), "scene_ms": 1e3 * float(np.mean(times)),
            "scene_ms_all": [1e3 * t for t in times]}


def predict_scene(runner: Runner, scene: np.ndarray, n_points: int, batch: int,
                  block_size: float = 1.5, stride: float = 0.75, rng=None) -> np.ndarray:
    """Full-scene prediction by sliding overlapping blocks over the xy plane
    and averaging per-point logits (``scannet.py:121``)."""
    rng = rng or np.random.default_rng(0)
    mins, maxs = scene.min(0), scene.max(0)
    xs = np.arange(mins[0], maxs[0] + 1e-6, stride)
    ys = np.arange(mins[1], maxs[1] + 1e-6, stride)
    logit_sum = None
    counts = np.zeros(len(scene), np.int64)
    half = block_size / 2.0
    pending = []  # (sel_idx, subsample_idx)

    def flush(pending):
        nonlocal logit_sum
        if not pending:
            return
        pts_b = [_normalize_np(scene[sel][idx]) for sel, idx in pending]
        out = runner.eval_logits({
            "points": np.stack(pts_b), "mask": np.ones((len(pending), n_points), bool),
        }).cpu().numpy()
        if logit_sum is None:
            logit_sum = np.zeros((len(scene), out.shape[-1]), np.float32)
        for (sel, idx), lo in zip(pending, out):
            np.add.at(logit_sum, sel[idx], lo)
            np.add.at(counts, sel[idx], 1)

    for cx in xs:
        for cy in ys:
            sel = np.nonzero((np.abs(scene[:, 0] - cx - half) <= half)
                             & (np.abs(scene[:, 1] - cy - half) <= half))[0]
            if len(sel) < 16:
                continue
            _, _, idx = pad_points(scene[sel], n_points, rng)
            pending.append((sel, idx))
            if len(pending) == batch:
                flush(pending)
                pending = []
    flush(pending)
    covered = counts > 0
    pred = np.zeros(len(scene), np.int32)
    if logit_sum is not None:
        pred[covered] = logit_sum[covered].argmax(-1)
    return pred


def _parse_radii(spec) -> tuple[float, ...] | None:
    if not spec:
        return None
    return tuple(float(r) for r in str(spec).split(","))


def main(argv=None):
    p = base_parser("ScanNet semantic segmentation (MCSeg)")
    p.add_argument("--n-classes", type=int, default=None)
    p.add_argument("--block-size", type=float, default=1.5)
    p.add_argument("--blocks-per-epoch", type=int, default=None)
    p.add_argument("--spatial-shards", type=int, default=1,
                   help="the spatially sharded trainer (not ported yet: raises above 1)")
    p.add_argument("--data-shards", type=int, default=1,
                   help="with --spatial-shards: scenes per step (not ported yet)")
    p.add_argument("--halo-cap", type=int, default=1024)
    p.add_argument("--radii", type=str, default=None,
                   help="comma-separated Poisson radii per level (default 0.05,0.15,0.4)")
    p.add_argument("--neighbor-k", type=int, default=None,
                   help="MCSeg's neighbor_k: the capacity of a capacity-free level's "
                   "self-neighbour lists (the CLI always sizes a tile capacity above the "
                   "dense bound, so it is read only by models without one)")
    p.add_argument("--augment", action="store_true",
                   help="with --spatial-shards: per-epoch augmentation (not ported yet)")
    p.add_argument("--tile-pairs", type=int, default=None,
                   help="static z-order tile-pair capacity of the big-N conv / pdf / sampler "
                   "sites; default, and 0: sized from the first batch when --points exceeds "
                   "the dense bound (0 does not reach the bucket conv, as in the reference)")
    p.add_argument("--whole-scene-cap", type=int, default=None,
                   help="evaluate full scenes in one pass each, padded to this many points")
    p.add_argument("--conv-backend", choices=("auto", "tile"), default="auto",
                   help="auto routes each conv site by shape; tile forces the tile conv "
                   "at every site (the reference's MCCNN_TPU_CONV_BACKEND=tile)")
    p.set_defaults(points=8192, batch=8)
    args = p.parse_args(argv)

    if args.spatial_shards > 1 or args.data_shards > 1:
        raise NotImplementedError(
            "--spatial-shards / --data-shards: the spatially sharded trainer "
            "(mccnn_tpu/parallel/) is ported with the distribution slice (ROADMAP queue 1)"
        )
    rng = np.random.default_rng(args.seed)
    if args.synthetic:
        n_classes = args.n_classes or 8
        train_src = SyntheticSceneSource(8, n_classes, args.seed)
        test_src = SyntheticSceneSource(4, n_classes, args.seed + 1)
    else:
        train_src = datasets.load_scannet(args.data, "train")
        test_src = datasets.load_scannet(args.data, "test")
        n_classes = train_src.n_classes
    for src in (train_src, test_src):
        getattr(src, "_src", src).block_size = args.block_size
    weights = torch.from_numpy(datasets.class_weights_from(train_src.labels, n_classes))

    kw = {"n_classes": n_classes, "radii": _parse_radii(args.radii) or (0.05, 0.15, 0.4),
          "tile_pairs": args.tile_pairs or None, "conv_backend": args.conv_backend,
          "generator": torch.Generator().manual_seed(args.seed)}
    if args.grow:
        kw["grow"] = args.grow
    if args.neighbor_k:
        kw["neighbor_k"] = args.neighbor_k
    if args.bn_decay_steps:
        kw["bn_schedule_steps"] = args.bn_decay_steps
    model = MCSeg(**kw)
    example = next(train_src.batches(args.batch, args.points, np.random.default_rng(0)))

    def loss_fn(logits, batch):
        w = weights.to(logits.device)
        return (
            segmentation_loss(logits, batch["labels"], batch["mask"], class_weights=w),
            {"acc": masked_accuracy(logits, batch["labels"], batch["mask"])},
        )

    runner = Runner(args, model, loss_fn, "scannet_mcseg", example_batch=example)

    def run_eval():
        if args.whole_scene_cap:
            return evaluate_whole_scenes(runner, test_src, args.whole_scene_cap, n_classes)
        return evaluate(runner, test_src, args, rng, n_classes)

    if args.eval_only:
        res = run_eval()
        runner.metrics.log(runner.state.step, tag="eval", **res)
        runner.close()
        return res

    best = 0.0
    blocks_per_epoch = args.blocks_per_epoch
    if blocks_per_epoch is None and args.steps_per_epoch:
        blocks_per_epoch = args.batch * args.steps_per_epoch
    for epoch in range(runner.start_epoch, args.epochs):
        batches = train_src.batches(args.batch, args.points, rng, train_augment=True,
                                    protocol=args.protocol, blocks_per_epoch=blocks_per_epoch)
        runner.train_epoch(batches, epoch)
        if (epoch + 1) % args.eval_every == 0:
            res = run_eval()
            runner.metrics.log(runner.state.step, tag="eval", epoch=epoch, **res)
            if res["mIoU"] >= best:
                best = res["mIoU"]
                runner.save(epoch + 1)
    runner.metrics.log(runner.state.step, tag="final", best_mIoU=best)
    runner.close()
    return {"best_mIoU": best}


if __name__ == "__main__":
    main()
