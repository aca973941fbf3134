"""The capacity-free bucket path of mccnn_tpu_torch against the JAX package,
model by model, on the CPU.

MCSeg without a tile capacity at N just above 4096 points: level 0 is
sampled through its self-neighbour lists and the three level-0 conv sites
(stem, enc_0_1, dec_1_0) route to the cell-bucket conv by shape, whose plain
K9 / K10 versions run here. MCClassS at N = 3200 takes the bucket conv at
conv_0_1. The JAX models run their CPU route, the K-capacity neighbour-list
conv, with a ``neighbor_k`` no lower than the largest in-radius count of any
site (asserted), so that they are lossless like the bucket conv, and the
bucket layouts drop nothing (asserted). The points are dyadic (multiples of
1/256), so every d2 is exact in fp32 in both packages, whatever their
expression, and every in-radius test and sampler cell falls alike. Then the
CLIs on the bucket path's neighbours: ``tasks.modelnet --points 3200`` and
``tasks.scannet --tile-pairs 0``.
"""

import json
import re

import jax
import numpy as np
import pytest
import torch

from mccnn_tpu.api.hierarchy import build_hierarchy as j_build_hierarchy
from mccnn_tpu.models import MCClassS as JMCClassS
from mccnn_tpu.models import MCSeg as JMCSeg
from mccnn_tpu.train import segmentation_loss as j_segmentation_loss
from mccnn_tpu_torch.api.builder import SpatialCache
from mccnn_tpu_torch.api.hierarchy import build_hierarchy
from mccnn_tpu_torch.convert import load_flax_variables, torch_name
from mccnn_tpu_torch.core.grid import pair_d2, radius_sq
from mccnn_tpu_torch.models import MCClassS, MCSeg
from mccnn_tpu_torch.ops.cuda import mcconv_kernel, tile_conv
from mccnn_tpu_torch.tasks import modelnet, scannet
from mccnn_tpu_torch.train import (
    batch_to_device,
    init_state,
    make_optimizer,
    make_train_step,
    segmentation_loss,
)
import test_torch_mcclass_s as cls_t
import test_torch_mcseg as seg_t

N_SEG, N_CLS = 4104, 3200  # above DENSE_SAMPLER_MAX_N; above DENSE_MAX_N
SEG_RADII = (0.08, 0.15)
K_SEG, K_CLS = 128, 496  # the JAX models' neighbor_k: above every in-radius count
N_CLASSES, GROW = 5, 8


def dyadic_cloud(seed, n, b=1):
    rng = np.random.default_rng(seed)
    pts = (rng.integers(0, 256, size=(b, n, 3)) / 256.0).astype(np.float32)
    return pts, np.ones((b, n), bool)


def site_counts(hier, sites):
    """The largest in-radius count of each (in level, out level, radius) site."""
    out = []
    for i, o, r in sites:
        (src, sm), (smp, qm) = ((hier.levels[k].points, hier.levels[k].mask) for k in (i, o))
        inr = (pair_d2(smp, src) <= radius_sq(r)) & sm[:, None, :] & qm[:, :, None]
        out.append(int(inr.sum(-1).max()))
    return out


def seg_sites():
    r0, r1 = SEG_RADII
    return [(0, 0, r0), (0, 1, 2 * r0), (1, 0, 2 * r0), (1, 2, 2 * r1), (2, 1, 2 * r1)]


def seg_model(**kw):
    return MCSeg(N_CLASSES, grow=GROW, radii=SEG_RADII, neighbor_k=K_SEG, **kw)


@pytest.fixture(scope="module")
def seg_case():
    pts, mask = dyadic_cloud(11, N_SEG)
    labels = np.random.default_rng(12).integers(0, N_CLASSES, size=(1, N_SEG)).astype(np.int32)
    seeded = seg_model().eval()
    assert seeded.tile_pairs is None
    seg_t._seed_statistics(seeded, pts, mask, np.random.default_rng(13))
    jmodel = JMCSeg(n_classes=N_CLASSES, grow=GROW, radii=SEG_RADII, neighbor_k=K_SEG)
    jtrain = JMCSeg(n_classes=N_CLASSES, grow=GROW, radii=SEG_RADII, neighbor_k=K_SEG,
                    drop_rate=0.0)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), pts, mask, train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    variables = seg_t._flax_from_torch(seeded, template)

    @jax.jit
    def reference(v):
        hier = j_build_hierarchy(pts, mask, SEG_RADII, neighbor_k=K_SEG)
        logits = jmodel.apply(v, pts, mask, train=False)

        def loss_fn(params):
            out, upd = jtrain.apply({"params": params, "batch_stats": v["batch_stats"]},
                                    pts, mask, train=True, mutable=["batch_stats"])
            return j_segmentation_loss(out, labels, mask), upd["batch_stats"]

        step = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
        return [(l.sample.idx, l.mask) for l in hier.levels[1:]], logits, step

    levels, logits, step = reference(variables)
    return dict(pts=pts, mask=mask, labels=labels, variables=variables, levels=levels,
                want=np.asarray(logits), step=step)


def test_mcseg_bucket_hierarchy_and_counts(seg_case):
    pts, mask = (torch.from_numpy(seg_case[k]) for k in ("pts", "mask"))
    hier = build_hierarchy(pts, mask, SEG_RADII, neighbor_k=K_SEG)
    nbh = hier.levels[0].self_nbh
    assert nbh is not None and hier.levels[1].self_nbh is None  # level 1 is dense-sampled
    # the lists hold every neighbour, in both packages: the sampler is lossless
    assert int(nbh.count.max()) <= K_SEG
    assert max(site_counts(hier, seg_sites())) <= K_SEG
    for g, (idx, m) in zip(hier.levels[1:], seg_case["levels"]):
        np.testing.assert_array_equal(g.sample.idx.numpy(), np.asarray(idx))
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(m))
    # the bucket layouts of the three level-0 sites drop nothing
    cache = SpatialCache(hier)
    for i, o, r in seg_sites()[:3]:
        for lvl in (i, o):
            assert int(cache.buckets(lvl, r).overflow.max()) == 0


def test_mcseg_bucket_logits_match_jax(seg_case):
    model = seg_model()
    load_flax_variables(model, seg_case["variables"])
    before = (mcconv_kernel.launches, tile_conv.launches)
    with torch.inference_mode():
        got, overflow = model.eval()(torch.from_numpy(seg_case["pts"]),
                                     torch.from_numpy(seg_case["mask"]), with_overflow=True)
    assert (mcconv_kernel.launches, tile_conv.launches) == before  # plain versions on the CPU
    got, want = got.numpy(), seg_case["want"]
    assert int(overflow) == 0 and np.isfinite(got).all() and np.abs(want).max() > 0.1
    # as the tile path's test: identical hierarchies, then fp32 sums in other
    # orders through five convs and eleven BNs and dense layers
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_mcseg_bucket_train_step_matches_jax(seg_case, monkeypatch):
    (want_loss, want_stats), want_grads = seg_case["step"]
    model = seg_model(drop_rate=0.0)
    load_flax_variables(model, seg_case["variables"])
    opt = make_optimizer(model.parameters())
    init_state(model, opt, seed=0)
    step = make_train_step(model, opt, lambda out, b: (
        segmentation_loss(out, b["labels"], b["mask"]), {}))
    calls = []
    fwd = mcconv_kernel.BucketMCConvFunction.backward
    monkeypatch.setattr(mcconv_kernel.BucketMCConvFunction, "backward",
                        staticmethod(lambda ctx, d: calls.append(1) or fwd(ctx, d)))
    batch = batch_to_device({k: seg_case[k] for k in ("labels",)} |
                            {"points": seg_case["pts"], "mask": seg_case["mask"]},
                            torch.device("cpu"))
    loss, metrics = step(batch)
    # a bucket model has no tile capacity: no overflow check, one committed step
    assert "tile_overflow" not in metrics and opt.count == 1 and len(calls) == 3
    # the tile path's tolerances (test_torch_mcseg.py::test_train_step_matches_jax): the
    # loss 1e-5, each gradient 1e-3 of its largest value, the BN statistics
    # 1e-4; a mixing layer's bias feeds a batch-mean BN: both below 1e-6
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    top = max(np.abs(g).max() for g in grads.values())
    state = model.state_dict()
    for kind, tree, tol in (("grad", want_grads, 1e-3), ("stat", want_stats, 1e-4)):
        for path, want in seg_t._flat(tree):
            name, transpose = torch_name(path)
            got = grads[name] if kind == "grad" else state[name].numpy()
            got = got.T if transpose else got
            if kind == "grad" and re.fullmatch(r"(enc|dec)_mix_\d+/Dense_0/bias", path):
                assert max(np.abs(got).max(), np.abs(want).max()) < 1e-6 * top, path
                continue
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max(),
                                       err_msg=f"{kind} {path}")


def test_mcclass_s_bucket_conv_0_1_matches_jax():
    # two clouds: the head's seeded BN statistics then see more than one row
    pts, mask = dyadic_cloud(14, N_CLS, b=2)
    seeded = MCClassS(N_CLASSES, grow=GROW, neighbor_k=K_CLS).eval()
    cls_t._seed_statistics(seeded, pts, mask, np.random.default_rng(15))
    hier = build_hierarchy(torch.from_numpy(pts), torch.from_numpy(mask), seeded.radii,
                           global_level=True)
    counts = site_counts(hier, [(0, 1, 0.2), (1, 2, 0.8)])
    assert max(counts) <= K_CLS and int(SpatialCache(hier).buckets(0, 0.2).overflow.max()) == 0
    jmodel = JMCClassS(n_classes=N_CLASSES, grow=GROW, neighbor_k=K_CLS)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), pts, mask, train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    variables = cls_t._flax_from_torch(seeded, template)
    want = np.asarray(jax.jit(lambda v: jmodel.apply(v, pts, mask, train=False))(variables))
    model = MCClassS(N_CLASSES, grow=GROW, neighbor_k=K_CLS)
    load_flax_variables(model, variables)
    calls = []
    fwd = mcconv_kernel.bucket_conv_reference
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mcconv_kernel, "bucket_conv_reference",
                   lambda *a, **k: calls.append(1) or fwd(*a, **k))
        with torch.inference_mode():
            got = model.eval()(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    assert calls == [1]  # conv_0_1 took the bucket conv (one call for the batch)
    assert np.abs(want).max() > 0.1
    # identical hierarchies; fp32 sums in other orders through three convs and
    # three BN-dense layers (the serving slice's tolerance)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_modelnet_cli_trains_on_the_bucket_path(tmp_path, monkeypatch):
    # the CLI at N = 3200 (two steps, no evaluation epoch): conv_0_1 takes
    # the bucket conv forward and backward (the chip run evaluates too)
    calls = []
    bwd = mcconv_kernel.bucket_conv_backward_reference
    monkeypatch.setattr(mcconv_kernel, "bucket_conv_backward_reference",
                        lambda *a, **k: calls.append(1) or bwd(*a, **k))
    before = mcconv_kernel.launches
    res = modelnet.main(["--synthetic", "--device", "cpu", "--epochs", "1", "--steps-per-epoch",
                         "2", "--eval-every", "2", "--batch", "2", "--points", str(N_CLS),
                         "--grow", "8", "--log-dir", str(tmp_path), "--ckpt-dir",
                         str(tmp_path / "ck")])
    assert mcconv_kernel.launches == before and res == {"best_accuracy": 0.0}
    with open(tmp_path / "modelnet_MCClassS.metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["tag"] == "train"]
    assert len(train) == 1 and train[0]["steps"] == 2 and np.isfinite(train[0]["loss"])
    assert len(calls) == 2


def test_scannet_cli_tile_pairs_0_sizes_a_capacity(tmp_path, monkeypatch):
    # --tile-pairs 0 is "no capacity given", as in the reference's CLI: the
    # Runner sizes one from the first batch (the capacity-free bucket path is
    # for direct model users; the CLI never takes it)
    monkeypatch.setattr(scannet, "SyntheticSceneSource", seg_t.SmallScenes)
    built = []
    monkeypatch.setattr(scannet, "MCSeg", lambda **kw: built.append(MCSeg(**kw)) or built[-1])
    res = scannet.main(["--synthetic", "--eval-only", "--device", "cpu", "--batch", "1",
                        "--points", "3100", "--grow", "8", "--radii", "0.15,0.4",
                        "--tile-pairs", "0", "--neighbor-k", "40", "--log-dir", str(tmp_path),
                        "--ckpt-dir", str(tmp_path / "ck")])
    assert 0.0 <= res["mIoU"] <= 1.0 and res["batches"] > 0
    model = built[0]
    assert model.neighbor_k == 40
    assert model.tile_pairs is not None and model.tile_pairs > 0  # sized by the Runner
    assert model.tile_steps  # and the per-site budgets with it
