"""The ScanNet segmentation slice of mccnn_tpu_torch (MCSeg on the z-order
tile path) against the JAX package, on the CPU.

One small MCSeg (grow 8, radii 0.2 / 0.4, B = 2 clouds of N = 384 points, a
masked tail in one cloud) is built in both packages with the same weights
(through ``convert.py``) and seeded BN statistics near each BN input's RMS.
The port runs every conv site on the tile path (``conv_backend="tile"``) and,
once more, routed by shape (dense at this size); the JAX model runs its CPU
path, the K-capacity conv with ``neighbor_k = N``, which is lossless. One
train step (dropout 0) goes through the port's ``make_train_step`` on the tile
path (the tile convs' backward is the plain K6) against ``jax.value_and_grad``
of the JAX model in training mode. Then the scene data pipeline, the
segmentation losses, the overflow report and the ``tasks.scannet`` CLI (block
and whole-scene evaluation, and training, each with a capacity re-size) on
the CPU plain path.
"""

import json
import re

import jax
import numpy as np
import pytest
import torch

from mccnn_tpu.api.hierarchy import build_hierarchy as j_build_hierarchy
from mccnn_tpu.data import datasets as j_datasets
from mccnn_tpu.models import MCSeg as JMCSeg
from mccnn_tpu.train import masked_accuracy as j_masked_accuracy
from mccnn_tpu.train import segmentation_loss as j_segmentation_loss
from mccnn_tpu_torch.models.layers import Dropout
from mccnn_tpu_torch.api.hierarchy import build_hierarchy
from mccnn_tpu_torch.convert import load_flax_variables, torch_name
from mccnn_tpu_torch.data import datasets
from mccnn_tpu_torch.models import MCSeg
from mccnn_tpu_torch.models.layers import MaskedBatchNorm
from mccnn_tpu_torch.ops.cuda import tile_conv
from mccnn_tpu_torch.tasks import common, scannet
from mccnn_tpu_torch.train import (
    batch_to_device,
    init_state,
    make_optimizer,
    make_train_step,
    masked_accuracy,
    segmentation_loss,
)
from parity_utils import boundary_free

B, N, N_CLASSES, GROW = 2, 384, 5, 8
RADII = (0.2, 0.4)
SEED = 6


def _inputs():
    rng = np.random.default_rng(SEED)
    pts = rng.uniform(0, 1, size=(B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, -40:] = False
    return pts, mask


def _flax_from_torch(model, template):
    """The flax variables holding ``model``'s values (inverse of the converter)."""
    state = model.state_dict()

    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if hasattr(v, "items"):
                out[k] = walk(v, path)
            else:
                name, transpose = torch_name(path)
                t = state[name].numpy()
                out[k] = t.T.copy() if transpose else t.copy()
        return out

    return {c: walk(template[c], "") for c in ("params", "batch_stats")}


def _seed_statistics(model, pts, mask, rng):
    """Seeded conv biases, BN statistics near each BN input's moments and BN
    affine parameters: every term of the forward is exercised. One forward
    pass seeds every BN as it is reached, so each sees its input as the
    seeded BNs before it shape it."""
    model.eval()

    def seed(bn, inp):
        x = inp[0].reshape(-1, inp[0].shape[-1]).double()
        c = x.shape[-1]
        mean, rms = x.mean(0), x.square().mean(0).sqrt().clamp_min(1e-3)
        bn.mean.copy_(mean + 0.1 * rms * torch.from_numpy(rng.normal(size=c)))
        bn.var.copy_(rms**2 * torch.from_numpy(rng.uniform(0.5, 1.5, size=c)))
        bn.scale.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, size=c)))
        bn.bias.copy_(torch.from_numpy(rng.normal(size=c) * 0.1))

    with torch.no_grad():
        for conv in model.convs.values():
            conv.kernel_b1.copy_(torch.from_numpy(rng.normal(size=conv.kernel_b1.shape) * 0.1))
            conv.kernel_b2.copy_(torch.from_numpy(rng.normal(size=conv.kernel_b2.shape) * 0.1))
        hooks = [m.register_forward_pre_hook(seed) for m in model.modules()
                 if isinstance(m, MaskedBatchNorm)]
        try:
            model(torch.from_numpy(pts), torch.from_numpy(mask))
        finally:
            for h in hooks:
                h.remove()


def _port_model(backend, variables=None):
    model = MCSeg(N_CLASSES, grow=GROW, radii=RADII, tile_pairs=1 << 30, conv_backend=backend)
    if variables is not None:
        load_flax_variables(model, variables)
    return model.eval()


@pytest.fixture(scope="module")
def case():
    pts, mask = _inputs()
    jmodel = JMCSeg(n_classes=N_CLASSES, grow=GROW, radii=RADII, neighbor_k=N)
    # the flax tree's structure from an abstract init; the values come from
    # the port's seeded model, and one jitted apply runs the JAX forward
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), pts, mask, train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    seeded = _port_model("tile")
    _seed_statistics(seeded, pts, mask, np.random.default_rng(SEED))
    variables = _flax_from_torch(seeded, template)
    apply = jax.jit(lambda v, p, m: jmodel.apply(v, p, m, train=False))
    want = np.asarray(apply(variables, pts, mask))
    return dict(pts=pts, mask=mask, variables=variables, want=want)


def test_inputs_are_boundary_free(case):
    # exact hierarchy equality is claimed only away from every radius the
    # slice tests (Poisson 0.2 / 0.4, conv and KDE 0.2 / 0.4 / 0.8)
    assert boundary_free(case["pts"], case["mask"], [0.2, 0.4, 0.8])


def test_hierarchy_matches_jax(case):
    pts, mask = case["pts"], case["mask"]
    want = jax.jit(lambda p, m: j_build_hierarchy(p, m, RADII, neighbor_k=N))(pts, mask)
    got = build_hierarchy(torch.from_numpy(pts), torch.from_numpy(mask), RADII)
    assert len(got) == len(want) == 3
    for g, w in zip(got.levels[1:], want.levels[1:]):
        np.testing.assert_array_equal(g.sample.idx.numpy(), np.asarray(w.sample.idx))
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
        np.testing.assert_array_equal(g.points.numpy(), np.asarray(w.points))
        assert g.mask.sum() > 0 and (~g.mask).sum() > 0  # both real and padded slots


@pytest.mark.parametrize("backend", ["tile", "auto"])
def test_logits_match_jax(case, backend):
    model = _port_model(backend, case["variables"])
    with torch.inference_mode():
        got, overflow = model(torch.from_numpy(case["pts"]), torch.from_numpy(case["mask"]),
                              with_overflow=True)
    got = got.numpy()
    want = case["want"]
    assert int(overflow) == 0
    assert got.shape == (B, N, N_CLASSES) and np.isfinite(got).all()
    assert np.abs(want).max() > 0.1  # the seeded statistics give non-trivial logits
    assert (got[~case["mask"]] == 0).all()
    # rtol 1e-3 / atol 1e-3 * max|logit|: identical hierarchies, then fp32
    # sums in other orders through five convs, the KDE's d2 rounding and
    # eleven BNs and dense layers
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if hasattr(v, "items"):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


def test_train_step_matches_jax(case):
    pts, mask = case["pts"], case["mask"]
    labels = np.random.default_rng(SEED + 1).integers(0, N_CLASSES, size=(B, N)).astype(np.int32)
    jmodel = JMCSeg(n_classes=N_CLASSES, grow=GROW, radii=RADII, neighbor_k=N, drop_rate=0.0)

    @jax.jit
    def jax_step(variables):
        def loss_fn(params):
            out, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    pts, mask, train=True, mutable=["batch_stats"])
            return j_segmentation_loss(out, labels, mask), upd["batch_stats"]

        return jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])

    (want_loss, want_stats), want_grads = jax_step(case["variables"])
    model = MCSeg(N_CLASSES, grow=GROW, radii=RADII, tile_pairs=1 << 30, conv_backend="tile",
                  drop_rate=0.0)
    load_flax_variables(model, case["variables"])
    opt = make_optimizer(model.parameters())
    init_state(model, opt, seed=0)
    step = make_train_step(model, opt, lambda out, b: (
        segmentation_loss(out, b["labels"], b["mask"]), {}))
    batch = batch_to_device({"points": pts, "mask": mask, "labels": labels}, torch.device("cpu"))
    loss, metrics = step(batch)
    assert int(metrics["tile_overflow"]) == 0 and opt.count == 1
    # Port vs JAX, both fp32 on the CPU, identical hierarchies (boundary-free
    # inputs): the loss 1e-5 (fp32 sums in other orders through seven convs,
    # the KDE's d2 rounding and the BNs); each gradient 1e-3 of its largest
    # value (the backward runs through thirteen batch-statistic BNs); the BN
    # running statistics 1e-4 of their largest value. A mixing layer's bias
    # feeds a BN that subtracts the batch mean, so its gradient is 0 up to
    # rounding: both sides must be below 1e-6 of the largest gradient.
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    top = max(np.abs(g).max() for g in grads.values())
    state = model.state_dict()
    for kind, tree, tol in (("grad", want_grads, 1e-3), ("stat", want_stats, 1e-4)):
        for path, want in _flat(tree):
            name, transpose = torch_name(path)
            got = grads[name] if kind == "grad" else state[name].numpy()
            got = got.T if transpose else got
            if kind == "grad" and re.fullmatch(r"(enc|dec)_mix_\d+/Dense_0/bias", path):
                assert max(np.abs(got).max(), np.abs(want).max()) < 1e-6 * top, path
                continue
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max(),
                                       err_msg=f"{kind} {path}")


def test_tile_overflow_is_reported_or_raises(case):
    model = _port_model("tile", case["variables"])
    model.tile_steps = {("conv", 0, 0, 0.2): 1}  # one step for three sample tiles
    args = (torch.from_numpy(case["pts"]), torch.from_numpy(case["mask"]))
    with torch.inference_mode():
        _, overflow = model(*args, with_overflow=True)
        assert int(overflow) == 2
        with pytest.raises(RuntimeError, match="tile capacity overflow"):
            model(*args)


def test_converter_maps_mcseg_names(case):
    assert torch_name("stem/kernel_w2") == ("convs.stem.kernel_w2", False)
    assert torch_name("dec_2_1/kernel_b1") == ("convs.dec_2_1.kernel_b1", False)
    assert torch_name("enc_mix_bn_2/MaskedBatchNorm_0/var") == ("bns.enc_mix_bn_2.bn.var", False)
    assert torch_name("stem_bn/MaskedBatchNorm_0/scale") == ("bns.stem_bn.bn.scale", False)
    assert torch_name("dec_mix_0/Dense_0/kernel") == ("mixes.dec_mix_0.weight", True)
    assert torch_name("logits/kernel") == ("logits.weight", True)
    # every parameter and statistic of the port's model is set from the flax tree
    names = set(_port_model("auto", case["variables"]).state_dict())
    flat = set()
    for coll in ("params", "batch_stats"):
        stack = [("", case["variables"][coll])]
        while stack:
            prefix, tree = stack.pop()
            for k, v in tree.items():
                path = f"{prefix}/{k}" if prefix else k
                if hasattr(v, "items"):
                    stack.append((path, v))
                else:
                    flat.add(torch_name(path)[0])
    assert flat == names


def test_segmentation_loss_and_accuracy_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 50, 6)).astype(np.float32)
    labels = rng.integers(0, 6, size=(2, 50)).astype(np.int32)
    mask = rng.uniform(size=(2, 50)) < 0.8
    weights = rng.uniform(0.5, 2.0, size=6).astype(np.float32)
    t = [torch.from_numpy(a) for a in (logits, labels, mask, weights)]
    # the JAX side as one compiled program: both losses and the accuracy
    wants = jax.jit(lambda lg, lb, m, w: (
        j_segmentation_loss(lg, lb, m, None), j_segmentation_loss(lg, lb, m, w),
        j_masked_accuracy(lg, lb, m)))(logits, labels, mask, weights)
    for w, want in zip((None, t[3]), wants[:2]):
        got = float(segmentation_loss(*t[:3], class_weights=w))
        np.testing.assert_allclose(got, float(want), rtol=1e-6)
    assert float(masked_accuracy(*t[:3])) == pytest.approx(float(wants[2]), rel=1e-6)


class SmallScenes(scannet.SyntheticSceneSource):
    """The CLI's synthetic rooms at 1100-1250 points a scene."""

    def __init__(self, n_scenes, n_classes, seed):
        rng = np.random.default_rng(seed)
        scenes, labels = [], []
        for _ in range(n_scenes):
            pts = rng.uniform(0, 1, size=(rng.integers(1100, 1250), 3)).astype(np.float32)
            pts[:, :2] *= 6.0
            scenes.append(pts)
            labels.append(np.minimum((pts[:, 2] * n_classes).astype(np.int32), n_classes - 1))
        self._src = datasets.SceneSegSource(scenes, labels, n_classes)
        self.n_classes, self.labels = n_classes, labels


@pytest.mark.parametrize("augment", [False, True])
def test_scene_batches_and_class_weights_match_jax_numpy_branch(monkeypatch, augment):
    monkeypatch.setenv("MCCNN_HOST_PIPE", "numpy")
    src = SmallScenes(3, 4, seed=5)
    args = (src._src.scenes, src._src.labels, 4)
    kw = dict(train_augment=augment, drop_remainder=False, blocks_per_epoch=5)
    got = list(datasets.SceneSegSource(*args).batches(2, 200, np.random.default_rng(6), **kw))
    want = list(j_datasets.SceneSegSource(*args).batches(2, 200, np.random.default_rng(6), **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    np.testing.assert_array_equal(datasets.class_weights_from(src.labels, 4),
                                  j_datasets.class_weights_from(src.labels, 4))


# The CLI at a tiny size: N > 1024 in a whole scene gives a sample tile more
# than one step's worth of candidate minors, so a short --tile-pairs drops
# steps there and evaluation re-sizes the capacity.
CLI = ["--synthetic", "--eval-only", "--device", "cpu", "--batch", "2", "--points", "256",
       "--grow", "8", "--radii", "0.4,0.8", "--conv-backend", "tile", "--tile-pairs", "32"]


def test_scannet_cli_evaluates_blocks_and_whole_scenes_with_a_resize(tmp_path, monkeypatch):
    monkeypatch.setattr(scannet, "SyntheticSceneSource", SmallScenes)
    logs = str(tmp_path / "logs")
    res = scannet.main(CLI + ["--log-dir", logs, "--ckpt-dir", str(tmp_path / "ck")])
    assert res["batches"] == 8 and 0.0 <= res["mIoU"] <= 1.0 and res["batch_ms"] > 0
    whole = scannet.main(CLI + ["--whole-scene-cap", "1280", "--log-dir", logs,
                                "--ckpt-dir", str(tmp_path / "ck")])
    assert whole["scenes"] == 4 and 0.0 <= whole["point_accuracy"] <= 1.0
    with open(tmp_path / "logs" / "scannet_mcseg.metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    resizes = [r for r in recs if r["tag"] == "resize"]
    assert [r["tag"] for r in recs].count("eval") == 2
    assert len(resizes) >= 1 and resizes[0]["phase"] == "eval"
    assert resizes[0]["tile_overflow"] > 0 and resizes[0]["tile_pairs"] > 32


class RecordingMCSeg(MCSeg):
    """MCSeg that records, for each training forward, its BN buffers and the
    dropout generator's state as the forward starts, and its overflow."""

    calls: list = []

    def forward(self, *args, **kw):
        if not self.training:
            return super().forward(*args, **kw)
        gens = {m.generator for m in self.modules() if isinstance(m, Dropout) and m.rate > 0}
        assert len(gens) == 1
        rec = {"gen": next(iter(gens)).get_state().clone(),
               "bufs": [b.clone() for b in self.buffers()]}
        out = super().forward(*args, **kw)
        rec["overflow"] = int(out[1])
        RecordingMCSeg.calls.append(rec)
        return out


def test_scannet_cli_trains_and_reruns_a_discarded_step_after_a_resize(tmp_path, monkeypatch):
    # 1100 points a block: a sample tile meets more than one step's worth of
    # candidate minors, so --tile-pairs 32 drops steps in training
    monkeypatch.setattr(scannet, "SyntheticSceneSource", SmallScenes)
    monkeypatch.setattr(scannet, "MCSeg", RecordingMCSeg)
    monkeypatch.setattr(RecordingMCSeg, "calls", [])
    logs = str(tmp_path / "logs")
    res = scannet.main(["--synthetic", "--device", "cpu", "--batch", "2", "--points", "1100",
                        "--grow", "8", "--radii", "0.4,0.8", "--conv-backend", "tile",
                        "--tile-pairs", "32", "--epochs", "1", "--steps-per-epoch", "2",
                        "--eval-every", "2", "--log-dir", logs, "--ckpt-dir",
                        str(tmp_path / "ck")])
    assert res == {"best_mIoU": 0.0}  # no eval epoch ran
    with open(tmp_path / "logs" / "scannet_mcseg.metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    resizes = [r for r in recs if r["tag"] == "resize"]
    train = [r for r in recs if r["tag"] == "train"]
    assert len(train) == 1 and train[0]["steps"] == 2 and np.isfinite(train[0]["loss"])
    assert len(resizes) >= 1 and train[0]["capacity_resizes"] == len(resizes)
    assert train[0]["tile_overflow"] == 0.0  # the committed steps dropped nothing
    for r in resizes:  # the reference's keys
        assert set(r) >= {"tile_overflow", "attempt", "tile_pairs", "tile_pairs_old"}
        assert r["tile_overflow"] > 0 and r["tile_pairs"] > r["tile_pairs_old"]
    calls = RecordingMCSeg.calls
    assert len(calls) == 2 + len(resizes)
    dropped = [k for k, c in enumerate(calls) if c["overflow"] > 0]
    assert len(dropped) == len(resizes)
    for k in dropped:  # the step ran again from the same BN buffers and dropout state
        again = calls[k + 1]
        assert torch.equal(again["gen"], calls[k]["gen"])
        assert all(torch.equal(a, b) for a, b in zip(again["bufs"], calls[k]["bufs"]))
    last = calls[-1]  # a committed step moves both on
    assert not torch.equal(last["gen"], calls[0]["gen"])
    assert not all(torch.equal(a, b) for a, b in zip(last["bufs"], calls[0]["bufs"]))


def test_predict_scene_batches_blocks_unpadded_and_covers_the_scene(tmp_path):
    # sliding-window prediction runs its ragged last batch as it is: in eval
    # mode no block's logits depend on the others, so batches of 3 (the last
    # one short) predict what one batch of every block does
    args = common.base_parser("predict_scene").parse_args(
        ["--device", "cpu", "--log-dir", str(tmp_path), "--ckpt-dir", str(tmp_path / "ck")])
    model = MCSeg(4, grow=8, radii=(0.4,), tile_pairs=1 << 30, conv_backend="tile",
                  generator=torch.Generator().manual_seed(0))
    runner = common.Runner(args, model, lambda logits, batch: (logits.sum(), {}), "scene")
    scene = SmallScenes(1, 4, seed=8)._src.scenes[0][:600] * np.float32([0.5, 0.5, 1.0])
    try:
        kw = dict(block_size=1.5, stride=1.5)
        preds = [scannet.predict_scene(runner, scene, 128, b, **kw) for b in (3, 16)]
    finally:
        runner.close()
    assert preds[0].shape == (len(scene),) and 0 <= preds[0].min() and preds[0].max() < 4
    np.testing.assert_array_equal(preds[0], preds[1])


def test_scannet_cli_unported_options_raise(tmp_path):
    # (--tile-pairs 0 runs: test_torch_bucket_models.py)
    base = ["--synthetic", "--eval-only", "--device", "cpu", "--log-dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="sharded"):
        scannet.main(base + ["--spatial-shards", "2"])


def test_tile_kernel_wrappers_count_no_cpu_launch(case):
    before = (tile_conv.launches, tile_conv.kde_launches, tile_conv.cover_launches)
    model = _port_model("tile", case["variables"])
    with torch.inference_mode():
        model(torch.from_numpy(case["pts"]), torch.from_numpy(case["mask"]))
    assert (tile_conv.launches, tile_conv.kde_launches, tile_conv.cover_launches) == before
