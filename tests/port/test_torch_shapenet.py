"""ShapeNet part segmentation in mccnn_tpu_torch (the category one-hot through
training and serving, ``iou_per_class``, the part-segmentation data, the
evaluation's IoU bookkeeping and ``tasks.shapenet``) against the JAX
package, on the CPU.

One small MCSeg (grow 8, radii 0.2 / 0.4, four parts, four categories, B = 3
clouds of N = 256 points, a masked tail in one cloud) is built in both
packages with the same weights (through ``convert.py``) and seeded BN
statistics; the JAX model runs with ``neighbor_k = N`` (lossless, like the
port's dense conv). Both get the same category one-hot: the port through
``make_train_step`` and ``serve.Predictor`` (whose model arguments carry the
batch's ``category_onehot``), the JAX model as its fourth argument.
Tolerances as ``test_torch_mcseg.py``'s: logits 1e-3 of the largest, one
train step's loss 1e-5, each gradient 1e-3 of its largest value, BN
statistics 1e-4; a mixing layer's bias has a zero gradient up to rounding.
"""

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from mccnn_tpu.data import synthetic as j_synthetic
from mccnn_tpu.models import MCSeg as JMCSeg
from mccnn_tpu.tasks import shapenet as j_shapenet
from mccnn_tpu.train import iou_per_class as j_iou_per_class
from mccnn_tpu.train import segmentation_loss as j_segmentation_loss
from mccnn_tpu_torch.convert import load_flax_variables, torch_name
from mccnn_tpu_torch.data import datasets, synthetic
from mccnn_tpu_torch.models import MCSeg
from mccnn_tpu_torch.models.layers import MaskedBatchNorm
from mccnn_tpu_torch.ops.cuda import poisson_kernel
from mccnn_tpu_torch.serve import Predictor
from mccnn_tpu_torch.tasks import shapenet
from mccnn_tpu_torch.train import (batch_to_device, init_state, iou_per_class, make_optimizer,
                                   make_train_step)
from parity_utils import boundary_free
from test_torch_mcseg import _flax_from_torch

B, N, N_PARTS, N_CATS, GROW = 3, 256, 4, 4, 8
RADII = (0.2, 0.4)
SEED = 7


def _inputs():
    rng = np.random.default_rng(SEED)
    pts = rng.uniform(0, 1, size=(B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, -30:] = False
    labels = rng.integers(0, N_PARTS, size=(B, N)).astype(np.int32)
    onehot = np.eye(N_CATS, dtype=np.float32)[[1, 3, 0]]
    return pts, mask, labels, onehot


def _seed_statistics(model, pts, mask, onehot, rng):
    """``test_torch_mcseg.py``'s recipe, with the one-hot in the forward."""
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
            model(*(torch.from_numpy(a) for a in (pts, mask)), None, torch.from_numpy(onehot))
        finally:
            for h in hooks:
                h.remove()


def _port_model(variables=None):
    model = MCSeg(N_PARTS, grow=GROW, radii=RADII, n_categories=N_CATS, drop_rate=0.0)
    if variables is not None:
        load_flax_variables(model, variables)
    return model


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if hasattr(v, "items"):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


@pytest.fixture(scope="module")
def seg():
    pts, mask, labels, onehot = _inputs()
    jmodel = JMCSeg(n_classes=N_PARTS, grow=GROW, radii=RADII, neighbor_k=N, drop_rate=0.0)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), pts, mask, None, onehot,
                                                train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    seeded = _port_model()
    _seed_statistics(seeded, pts, mask, onehot, np.random.default_rng(SEED))
    variables = _flax_from_torch(seeded, template)

    def run(v):
        def train_loss(params):
            out, upd = jmodel.apply({"params": params, "batch_stats": v["batch_stats"]}, pts,
                                    mask, None, onehot, train=True, mutable=["batch_stats"])
            return j_segmentation_loss(out, labels, mask), upd["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(train_loss, has_aux=True)(v["params"])
        return jmodel.apply(v, pts, mask, None, onehot, train=False), loss, grads, stats

    want, loss, grads, stats = jax.tree.map(np.asarray, jax.jit(run)(variables))
    return dict(pts=pts, mask=mask, labels=labels, onehot=onehot, variables=variables,
                want=want, loss=float(loss), grads=grads, stats=stats)


def test_inputs_are_boundary_free():
    pts, mask, _, _ = _inputs()
    assert boundary_free(pts, mask, [0.2, 0.4, 0.8])


def test_category_onehot_reaches_mcseg_in_serving_and_training(seg):
    """The batch's ``category_onehot`` is a model argument of
    ``serve.Predictor`` and of ``make_train_step`` (``train/state.py:48-54``
    of the reference): the port equals the JAX MCSeg given the same one-hot."""
    pts, mask, onehot, want = seg["pts"], seg["mask"], seg["onehot"], seg["want"]
    predictor = Predictor(_port_model(seg["variables"]), batch_size=B)
    got = predictor.predict({"points": pts, "mask": mask, "category_onehot": onehot}).numpy()
    assert got.shape == (B, N, N_PARTS) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    one = predictor.predict({"points": pts[2:], "mask": mask[2:], "category_onehot": onehot[2:]})
    np.testing.assert_allclose(one.numpy(), want[2:], rtol=1e-3, atol=1e-3 * np.abs(want).max())

    model = _port_model(seg["variables"])
    opt = make_optimizer(model.parameters())
    init_state(model, opt, seed=0)
    step = make_train_step(model, opt, shapenet.loss_fn)
    batch = {"points": pts, "mask": mask, "labels": seg["labels"], "category_onehot": onehot}
    loss, metrics = step(batch_to_device(batch, torch.device("cpu")))
    assert set(metrics) == {"acc"} and opt.count == 1
    np.testing.assert_allclose(float(loss), seg["loss"], rtol=1e-5)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    top = max(np.abs(g).max() for g in grads.values())
    state = model.state_dict()
    for kind, tree, tol in (("grad", seg["grads"], 1e-3), ("stat", seg["stats"], 1e-4)):
        for path, w in _flat(tree):
            name, transpose = torch_name(path)
            g = grads[name] if kind == "grad" else state[name].numpy()
            g = g.T if transpose else g
            if kind == "grad" and re.fullmatch(r"(enc|dec)_mix_\d+/Dense_0/bias", path):
                assert max(np.abs(g).max(), np.abs(w).max()) < 1e-6 * top, path
                continue
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol * np.abs(w).max(),
                                       err_msg=f"{kind} {path}")
    # the stem takes 1 + N_CATS input channels: the one-hot is not optional
    assert model.convs["stem"].c_in == 1 + N_CATS


def test_iou_per_class_matches_jax():
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(2, 40, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=(2, 40)).astype(np.int32)
    mask = rng.uniform(size=(2, 40)) > 0.25
    got = iou_per_class(*(torch.from_numpy(a) for a in (logits, labels, mask)), 5)
    want = j_iou_per_class(logits, labels, mask, 5)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_part_segmentation_data_matches_jax(monkeypatch):
    monkeypatch.setenv("MCCNN_HOST_PIPE", "numpy")  # the reference's numpy branch
    for fn in ("segmentation_batch", "normals_batch"):
        args = (5, 32, 3) if fn == "segmentation_batch" else (5, 32)
        got = getattr(synthetic, fn)(np.random.default_rng(9), *args)
        want = getattr(j_synthetic, fn)(np.random.default_rng(9), *args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=fn)
    port = shapenet.SyntheticSegSource(6, 3, 16, seed=10)
    ref = j_shapenet.SyntheticSegSource(6, 3, 16, seed=10)
    np.testing.assert_array_equal(port.categories, ref.categories)
    kw = dict(train_augment=True, drop_remainder=False)
    got = list(port.batches(4, 48, np.random.default_rng(11), **kw))
    want = list(ref.batches(4, 48, np.random.default_rng(11), **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["category_onehot", "labels", "mask", "points"]
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_load_shapenet_part_reads_the_layout(tmp_path):
    rng = np.random.default_rng(12)
    entries, written = [], {}
    for synset, mids in (("02691156", ["a1", "a2"]), ("03001627", ["c1"])):
        for sub in ("points", "points_label"):
            os.makedirs(tmp_path / synset / sub, exist_ok=True)
        for mid in mids:
            pts = np.round(rng.uniform(-1, 1, size=(10, 3)), 4).astype(np.float32)
            seg = rng.integers(1, 4, size=10)
            np.savetxt(tmp_path / synset / "points" / f"{mid}.pts", pts, fmt="%.4f")
            np.savetxt(tmp_path / synset / "points_label" / f"{mid}.seg", seg, fmt="%d")
            entries.append(f"shape_data/{synset}/{mid}")
            written[mid] = (pts, seg - 1)
    os.makedirs(tmp_path / "train_test_split")
    order = [entries[2], entries[0]]
    with open(tmp_path / "train_test_split" / "shuffled_train_file_list.json", "w") as f:
        json.dump(order, f)
    src = datasets.load_shapenet_part(str(tmp_path), "train")
    assert src.n_categories == 2 and list(src.categories) == [1, 0]
    assert src.n_parts == 1 + max(int(written[m][1].max()) for m in ("c1", "a1"))
    for k, mid in enumerate(("c1", "a1")):
        np.testing.assert_array_equal(src.clouds[k], written[mid][0])
        np.testing.assert_array_equal(src.point_labels[k], written[mid][1])
        assert src.point_labels[k].dtype == np.int32
    with pytest.raises(FileNotFoundError, match="--synthetic"):
        datasets.load_shapenet_part(str(tmp_path), "test")


class _FixedRunner:
    """Stands in for a Runner: eval logits from a fixed per-cloud table."""

    def __init__(self, logits, as_tensor):
        self.logits, self.as_tensor, self.k = logits, as_tensor, 0

    def eval_logits(self, batch):
        out = self.logits[self.k : self.k + len(batch["points"])]
        self.k += len(out)
        return torch.from_numpy(out) if self.as_tensor else out


def test_evaluate_bookkeeping_matches_jax(monkeypatch):
    """Point accuracy, class mIoU and instance mIoU from the same logits
    (every cloud once, the last batch ragged)."""
    monkeypatch.setenv("MCCNN_HOST_PIPE", "numpy")  # the same labels drawn on both sides

    class Args:
        batch, points = 4, 48

    src = shapenet.SyntheticSegSource(6, 4, 16, seed=13)
    logits = np.random.default_rng(14).normal(size=(6, 48, 4)).astype(np.float32)
    got = shapenet.evaluate(_FixedRunner(logits, True), src, Args, np.random.default_rng(15))
    ref = j_shapenet.SyntheticSegSource(6, 4, 16, seed=13)
    want = j_shapenet.evaluate(_FixedRunner(logits, False), ref, Args, np.random.default_rng(15))
    assert got == want


def test_shapenet_cli_trains_and_evaluates_under_v1_and_v3(tmp_path, monkeypatch):
    """``tasks.shapenet`` trains MCSeg with the one-hot and evaluates; under
    MCCNN_POISSON_SWEEP=v3 (the module constant) its 300-point levels take
    the v3 sweep and the run is the same."""
    runs = {}
    for variant in ("v1", "v3"):
        monkeypatch.setattr(poisson_kernel, "_SWEEP", variant)
        poisson_kernel.routes.clear()
        d = tmp_path / variant
        res = shapenet.main(["--synthetic", "--device", "cpu", "--epochs", "1",
                             "--steps-per-epoch", "2", "--batch", "4", "--points", "300",
                             "--grow", "8", "--log-dir", str(d / "logs"), "--ckpt-dir",
                             str(d / "ck")])
        with open(d / "logs" / "shapenet_mcseg.metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        train = [r for r in recs if r["tag"] == "train"]
        evals = [r for r in recs if r["tag"] == "eval"]
        assert len(train) == 1 and train[0]["steps"] == 2 and np.isfinite(train[0]["loss"])
        assert len(evals) == 1 and 0.0 <= evals[0]["mIoU_class"] <= 1.0
        assert 0.0 <= res["best_mIoU"] <= 1.0
        assert poisson_kernel.routes[variant] > 0 and set(poisson_kernel.routes) == {variant}
        runs[variant] = (train[0]["loss"], {k: v for k, v in evals[0].items() if k != "t"})
    assert runs["v1"] == runs["v3"]
