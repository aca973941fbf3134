"""Normal estimation in mccnn_tpu_torch (MCNorm, MCNormS, ``normal_loss``, the
normals data source and ``tasks.normals``) against the JAX package, on the CPU.

Small models (grow 8, B = 3 spheres of N = 256 points with their analytic
normals, a masked tail in one cloud) are built once per model in both
packages with the same weights (through ``convert.py``) and seeded BN
statistics (``test_torch_mcclass_s.py``'s recipe). ``neighbor_k = N`` makes
the JAX models' CPU conv (the K-capacity jnp path) lossless like the dense
conv the port runs. Each JAX model's eval forward and train-mode gradient of
``normal_loss`` are compiled as one program.

Tolerances (both sides fp32 on the CPU, identical hierarchies on
boundary-free inputs): the normals within 1e-3 of their largest value, as
the MCSeg and MCClassS slices hold their logits; one train step's loss 1e-5,
each gradient 2e-3 of its tensor's largest value and the BN statistics 1e-4.
The train step runs unpadded clouds and a nonzero output bias: the
reference's ``normal_loss`` has NaN gradients at a zero prediction
(``test_normal_loss_and_angular_error_match_jax``).
A ``dec_mix`` bias feeds a batch-statistic BN, so its gradient is 0 up to
rounding on both sides.
"""

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from mccnn_tpu.models import MCNorm as JMCNorm
from mccnn_tpu.models import MCNormS as JMCNormS
from mccnn_tpu.tasks import normals as j_normals
from mccnn_tpu.train import normal_loss as j_normal_loss
from mccnn_tpu_torch.convert import load_flax_variables, torch_name
from mccnn_tpu_torch.data import datasets
from mccnn_tpu_torch.data.datasets import _normalize_np
from mccnn_tpu_torch.data.synthetic import normals_batch
from mccnn_tpu_torch.models import MCNorm, MCNormS
from mccnn_tpu_torch.ops.cuda import poisson_kernel
from mccnn_tpu_torch.serve import make_predict_fn
from mccnn_tpu_torch.tasks import normals
from mccnn_tpu_torch.train import (batch_to_device, init_state, make_optimizer, make_train_step,
                                   normal_loss)
from parity_utils import boundary_free
from test_torch_mcclass_s import _flax_from_torch, _seed_statistics

B, N, GROW = 3, 256, 8
SEED = 0
MODELS = {"MCNorm": (MCNorm, JMCNorm), "MCNormS": (MCNormS, JMCNormS)}
OUT_TOL, LOSS_TOL, GRAD_TOL, STAT_TOL = 1e-3, 1e-5, 2e-3, 1e-4


def _inputs():
    rng = np.random.default_rng(SEED)
    pts, nrm = normals_batch(rng, B, N)
    pts = np.stack([_normalize_np(p) for p in pts])
    mask = np.ones((B, N), bool)
    mask[1, -20:] = False
    return pts, mask, nrm


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if hasattr(v, "items"):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


def _zero_grad(path: str) -> bool:
    return re.fullmatch(r"(trunk/)?dec_mix_\d+/Dense_0/bias", path) is not None


@pytest.fixture(scope="module", params=list(MODELS))
def case(request):
    name = request.param
    pts, mask, nrm = _inputs()
    full = np.ones_like(mask)  # the train step's mask (see test_normal_loss_...)
    jmodel = MODELS[name][1](grow=GROW, neighbor_k=N)
    template = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), pts, mask, train=False))
    seeded = MODELS[name][0](grow=GROW)
    _seed_statistics(seeded, pts, mask, np.random.default_rng(SEED))
    with torch.no_grad():  # no point's normal exactly 0 (see test_normal_loss_...)
        head = seeded.trunk.normals if name == "MCNormS" else seeded.normals
        head.bias.copy_(torch.tensor([0.3, -0.2, 0.1]))
    variables = _flax_from_torch(seeded, template)

    def run(v):
        def train_loss(params):
            out, upd = jmodel.apply({"params": params, "batch_stats": v["batch_stats"]}, pts,
                                    full, train=True, mutable=["batch_stats"])
            return j_normal_loss(out, nrm, full), upd["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(train_loss, has_aux=True)(v["params"])
        return jmodel.apply(v, pts, mask, train=False), loss, grads, stats

    want, loss, grads, stats = jax.tree.map(np.asarray, jax.jit(run)(variables))
    model = MODELS[name][0](grow=GROW)
    load_flax_variables(model, variables)  # the port's weights come through the converter
    return dict(name=name, pts=pts, mask=mask, full=full, nrm=nrm, model=model,
                variables=variables,
                want=want, loss=float(loss), grads=grads, stats=stats)


def test_inputs_are_boundary_free():
    pts, mask, _ = _inputs()
    # Poisson 0.1 / 0.4 (MCNorm) and 0.15 (MCNormS); conv and KDE twice those
    assert boundary_free(pts, mask, [0.1, 0.15, 0.2, 0.3, 0.4, 0.8])


def test_eval_normals_match_jax(case):
    got = make_predict_fn(case["model"])(torch.from_numpy(case["pts"]),
                                         torch.from_numpy(case["mask"])).numpy()
    want = case["want"]
    assert got.shape == (B, N, 3) and np.isfinite(got).all()
    assert np.abs(want).max() > 0.1  # the seeded statistics give non-trivial normals
    assert not got[~case["mask"]].any()  # zero on padded points
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=OUT_TOL * np.abs(want).max())


def test_train_step_matches_jax_grad(case):
    model = MODELS[case["name"]][0](grow=GROW)
    load_flax_variables(model, case["variables"])
    opt = make_optimizer(model.parameters())
    init_state(model, opt, seed=0)
    step = make_train_step(model, opt, normals.loss_fn)
    batch = {"points": case["pts"], "mask": case["full"], "normals": case["nrm"]}
    loss, metrics = step(batch_to_device(batch, torch.device("cpu")))
    assert metrics == {} and opt.count == 1
    np.testing.assert_allclose(float(loss), case["loss"], rtol=LOSS_TOL)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    jgrads = dict(_flat(case["grads"]))
    assert len(jgrads) == len(grads)
    top = max(np.abs(g).max() for p, g in jgrads.items() if not _zero_grad(p))
    for path, want in jgrads.items():
        name, transpose = torch_name(path)
        got = grads[name].T if transpose else grads[name]
        if _zero_grad(path):
            assert max(np.abs(got).max(), np.abs(want).max()) < 1e-5 * top, path
            continue
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=f"grad {path}")
    state = model.state_dict()
    for path, want in _flat(case["stats"]):
        got = state[torch_name(path)[0]].numpy()
        np.testing.assert_allclose(got, want, rtol=STAT_TOL, atol=STAT_TOL * np.abs(want).max(),
                                   err_msg=path)


def test_converter_maps_every_leaf(case):
    variables = case["variables"]
    prefix = "trunk/" if case["name"] == "MCNormS" else ""
    tp = "trunk." if prefix else ""
    assert torch_name(f"{prefix}normals/kernel") == (f"{tp}normals.weight", True)
    assert torch_name(f"{prefix}normals/bias") == (f"{tp}normals.bias", False)
    assert torch_name(f"{prefix}dec_mix_0/Dense_0/kernel") == (f"{tp}mixes.dec_mix_0.weight", True)
    assert torch_name(f"{prefix}enc_0_1/kernel_w1") == (f"{tp}convs.enc_0_1.kernel_w1", False)
    n_bn = 6 if case["name"] == "MCNorm" else 3
    assert torch_name(f"{prefix}BatchNormReluDropout_{n_bn - 1}/MaskedBatchNorm_0/var") == (
        f"{tp}bn_relus.{n_bn - 1}.bn.var", False)
    # every flax leaf has a torch tensor and every torch tensor a flax leaf
    leaves = [p for c in ("params", "batch_stats") for p, _ in _flat(variables[c])]
    assert sorted(torch_name(p)[0] for p in leaves) == sorted(case["model"].state_dict())
    cls = MODELS[case["name"]][0]
    params = dict(variables["params"])
    if prefix:
        params["trunk"] = dict(params["trunk"])
        del params["trunk"]["normals"]
    else:
        del params["normals"]
    with pytest.raises(KeyError, match="left unset"):
        load_flax_variables(cls(grow=GROW), {"params": params,
                                             "batch_stats": variables["batch_stats"]})


def test_normal_loss_and_angular_error_match_jax():
    rng = np.random.default_rng(3)
    pred = rng.normal(size=(2, 50, 3)).astype(np.float32)
    target = rng.normal(size=(2, 50, 3)).astype(np.float32)
    pred[0, :3] = 0.0  # zero vectors: the eps / floor path
    mask = rng.uniform(size=(2, 50)) > 0.2
    got = float(normal_loss(torch.from_numpy(pred), torch.from_numpy(target),
                            torch.from_numpy(mask)))
    np.testing.assert_allclose(got, float(j_normal_loss(pred, target, mask)), rtol=1e-6)
    assert normals.angular_error_deg(pred, target, mask) == j_normals.angular_error_deg(
        pred, target, mask)
    # the sign of a normal does not matter to either
    assert float(normal_loss(torch.from_numpy(-target), torch.from_numpy(target),
                             torch.from_numpy(mask))) < 1e-6
    # A known difference: at a zero prediction (a padded point, which the
    # models zero, or a point whose last features are all ReLU'd to 0 while
    # the output bias is 0) the reference's gradient is NaN (the norm's
    # derivative at 0), torch's norm takes the subgradient 0. The train step
    # test therefore runs unpadded clouds, as every task batch is, with a
    # nonzero output bias.
    p = torch.from_numpy(pred).requires_grad_()
    normal_loss(p, torch.from_numpy(target), torch.from_numpy(mask)).backward()
    assert torch.isfinite(p.grad).all() and not p.grad[0, :3].any()
    jgrad = np.asarray(jax.grad(lambda q: j_normal_loss(q, target, mask))(pred))
    assert np.isnan(jgrad[0, :3]).all() and np.isfinite(jgrad[0, 3:]).all()


def test_normals_source_matches_jax(monkeypatch):
    monkeypatch.setenv("MCCNN_HOST_PIPE", "numpy")  # the reference's numpy branch
    port = normals.NormalsSource.synthetic(6, seed=4)
    ref = j_normals.NormalsSource.synthetic(6, seed=4)
    for c, rc in zip(port.clouds + port.normals, ref.clouds + ref.normals):
        np.testing.assert_array_equal(c, rc)
    kw = dict(shuffle=True, protocol="gradient", drop_remainder=False)
    got = list(port.batches(4, 64, np.random.default_rng(5), **kw))
    want = list(ref.batches(4, 64, np.random.default_rng(5), **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["mask", "normals", "points"]
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_load_modelnet40_reads_normals(tmp_path):
    rng = np.random.default_rng(6)
    (tmp_path / "modelnet40_shape_names.txt").write_text("chair\ncup\n")
    (tmp_path / "modelnet40_train.txt").write_text("chair_0001\ncup_0001\n")
    tables = {}
    for mid, cols in (("chair_0001", 6), ("cup_0001", 3)):
        cls = mid.split("_")[0]
        os.makedirs(tmp_path / cls, exist_ok=True)
        tables[mid] = np.round(rng.uniform(-1, 1, size=(12, cols)), 4).astype(np.float32)
        np.savetxt(tmp_path / cls / f"{mid}.txt", tables[mid], fmt="%.4f", delimiter=",")
    src = datasets.load_modelnet40(str(tmp_path), "train")
    np.testing.assert_array_equal(src.labels, [0, 1])
    np.testing.assert_array_equal(src.clouds[0], tables["chair_0001"][:, :3])
    np.testing.assert_array_equal(src.normals[0], tables["chair_0001"][:, 3:6])
    assert src.normals[1] is None
    ns = normals.NormalsSource.from_modelnet(str(tmp_path), "train")  # models with normals
    assert len(ns.clouds) == 1
    np.testing.assert_array_equal(ns.normals[0], tables["chair_0001"][:, 3:6])


@pytest.mark.parametrize("name", list(MODELS))
def test_normals_cli_trains_and_evaluates_under_v1_and_v3(tmp_path, monkeypatch, name):
    """``tasks.normals`` trains and evaluates; under MCCNN_POISSON_SWEEP=v3 (the
    module constant) the 300-point levels take the v3 sweep and the run is
    the same."""
    runs = {}
    for variant in ("v1", "v3"):
        monkeypatch.setattr(poisson_kernel, "_SWEEP", variant)
        poisson_kernel.routes.clear()
        d = tmp_path / variant
        res = normals.main(["--synthetic", "--device", "cpu", "--model", name, "--epochs", "1",
                            "--steps-per-epoch", "2", "--batch", "4", "--points", "300",
                            "--grow", "8", "--log-dir", str(d / "logs"), "--ckpt-dir",
                            str(d / "ck")])
        with open(d / "logs" / f"normals_{name}.metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        train = [r for r in recs if r["tag"] == "train"]
        assert len(train) == 1 and train[0]["steps"] == 2 and np.isfinite(train[0]["loss"])
        assert [r["tag"] for r in recs].count("eval") == 1
        assert 0.0 <= res["best_angular_error"] <= 90.0
        assert poisson_kernel.routes[variant] > 0 and set(poisson_kernel.routes) == {variant}
        runs[variant] = (train[0]["loss"], res["best_angular_error"])
    assert runs["v1"] == runs["v3"]
