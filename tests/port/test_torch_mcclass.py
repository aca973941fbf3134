"""The classification zoo's MCClass and MCClassH of mccnn_tpu_torch against the
flax models, on the CPU: eval-mode logits through ``convert.py``, one train
step against ``jax.grad`` (drop rates 0; ``classh_loss`` for MCClassH), the
converter's rules, ``serve.Predictor`` / ``tasks.predict`` on MCClassH's
tuple, and ``tasks.modelnet`` training and voting with both.

Small models (grow 8, B = 3 clouds of N = 256 points, a masked tail in one
cloud) are built once per model in both packages with the same weights and
seeded BN statistics (``test_torch_mcclass_s.py``'s recipe). ``neighbor_k =
N`` makes the JAX models' CPU conv (the K-capacity jnp path) lossless like
the dense conv the port runs. Each JAX model's eval forward and train-mode
gradient are compiled as one program.

Tolerances (both sides fp32 on the CPU). MCClassH is held as MCClassS is
(test_torch_mcclass_s.py, test_torch_train.py): logits 1e-3 of the largest,
the loss 1e-5, each gradient 1e-3 of its tensor's largest value, BN
statistics 1e-4. MCClass, twelve BN layers deep with residual mixes, is
held looser, from measurement: its logits at 5e-3 (measured 2.5e-3) and its
gradients at 1e-2 (measured 4.3e-3), the loss at 3e-4. The fp32 step itself
is that sensitive at this size: the port's gradients sit up to 1.8e-3 from
the same step in float64, JAX's up to 5.0e-3. JAX's rounding starts at the
stem, whose density at r = 0.1 carries the JAX CPU KDE's self-pair rounding
(up to 1.3e-4 of a density here, 3.3e-5 at MCClassS's first radius; ROADMAP
"Known differences"); in mean mode the step is no better conditioned.
"""

import json

import jax
import numpy as np
import pytest
import torch

from mccnn_tpu.models import MCClass as JMCClass
from mccnn_tpu.models import MCClassH as JMCClassH
from mccnn_tpu.train import classh_loss as j_classh_loss
from mccnn_tpu.train import classification_loss as j_classification_loss
from mccnn_tpu_torch.convert import load_flax_variables, torch_name
from mccnn_tpu_torch.data.datasets import _normalize_np
from mccnn_tpu_torch.data.synthetic import classification_batch
from mccnn_tpu_torch.models import MCClass, MCClassH
from mccnn_tpu_torch.serve import Predictor, make_predict_fn
from mccnn_tpu_torch.tasks import modelnet
from mccnn_tpu_torch.tasks import predict as predict_task
from mccnn_tpu_torch.train import (batch_to_device, classh_loss, classification_loss,
                                   init_state, make_optimizer, make_train_step)
from parity_utils import boundary_free
from test_torch_mcclass_s import _flax_from_torch, _seed_statistics

B, N, N_CLASSES, GROW = 3, 256, 6, 8
SEED = 2
MODELS = {  # name: (port class, JAX class, loss of each side)
    "MCClass": (MCClass, JMCClass, classification_loss, j_classification_loss),
    "MCClassH": (MCClassH, JMCClassH, classh_loss, j_classh_loss),
}
# (logits, loss, gradients) tolerances, port vs JAX: see the module docstring.
TOLS = {"MCClass": (5e-3, 3e-4, 1e-2), "MCClassH": (1e-3, 1e-5, 1e-3)}
STAT_TOL = 1e-4  # BN running statistics, relative to their largest value


def _inputs():
    rng = np.random.default_rng(SEED)
    pts, _ = classification_batch(rng, B, N)
    pts = np.stack([_normalize_np(p) for p in pts])
    mask = np.ones((B, N), bool)
    mask[1, -20:] = False
    return pts, mask


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if hasattr(v, "items"):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


def _build(name: str, jax_model: bool = False):
    """The model at test size, drop rates 0, in either package."""
    kw = dict(n_classes=N_CLASSES, grow=GROW, drop_rate=0.0)
    if name == "MCClass":
        kw["point_drop_rate"] = 0.0
    return MODELS[name][1](neighbor_k=N, **kw) if jax_model else MODELS[name][0](**kw)


def _zero_grad(path: str) -> bool:
    """Dense biases that feed a batch-statistic BN: the BN subtracts their
    batch mean, so their gradient is 0 up to rounding (the head FC layers'
    and MCClass's ``mix_{o}``)."""
    head = ("FullyConnected_" in path or "_fc" in path) and "Dense_0/bias" in path
    return head or (path.startswith("mix_") and path.endswith("/bias"))


@pytest.fixture(scope="module", params=list(MODELS))
def zoo(request):
    name = request.param
    jloss = MODELS[name][3]
    pts, mask = _inputs()
    labels = np.array([1, 4, 0], np.int32)
    jmodel = _build(name, jax_model=True)
    template = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), pts, mask,
                                                  train=False))
    seeded = _build(name)
    _seed_statistics(seeded, pts, mask, np.random.default_rng(SEED))
    variables = _flax_from_torch(seeded, template)

    def run(v):
        def train_loss(params):
            out, upd = jmodel.apply({"params": params, "batch_stats": v["batch_stats"]}, pts,
                                    mask, train=True, mutable=["batch_stats"])
            return jloss(out, labels), upd["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(train_loss, has_aux=True)(v["params"])
        return jmodel.apply(v, pts, mask, train=False), loss, grads, stats

    want, loss, grads, stats = jax.tree.map(np.asarray, jax.jit(run)(variables))
    model = _build(name)
    load_flax_variables(model, variables)  # the port's weights come through the converter
    return dict(name=name, pts=pts, mask=mask, labels=labels, model=model,
                variables=variables, want=want, loss=float(loss), grads=grads, stats=stats)


def _joint(out):
    return out[0] if isinstance(out, tuple) else out


def test_inputs_are_boundary_free():
    pts, mask = _inputs()
    assert boundary_free(pts, mask, [0.1, 0.2, 0.4, 0.8])


def test_eval_logits_match_jax(zoo):
    got = make_predict_fn(zoo["model"])(torch.from_numpy(zoo["pts"]),
                                        torch.from_numpy(zoo["mask"]))
    want = zoo["want"]
    if zoo["name"] == "MCClassH":
        assert isinstance(got, tuple) and len(got) == len(want) == 3
    else:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == (B, N_CLASSES) and np.isfinite(g).all()
        assert np.abs(w).max() > 0.1  # the seeded statistics give non-trivial logits
        # identical hierarchies, then fp32 sums in other orders through the
        # convs, BNs and dense layers
        tol = TOLS[zoo["name"]][0]
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * np.abs(w).max())


def test_train_step_matches_jax_grad(zoo):
    model = _build(zoo["name"])
    load_flax_variables(model, zoo["variables"])
    opt = make_optimizer(model.parameters())
    init_state(model, opt, seed=0)
    step = make_train_step(model, opt, modelnet.make_loss(zoo["name"]))
    batch = {"points": zoo["pts"], "mask": zoo["mask"], "labels": zoo["labels"]}
    loss, metrics = step(batch_to_device(batch, torch.device("cpu")))
    assert set(metrics) == {"acc"} and opt.count == 1
    _, loss_tol, grad_tol = TOLS[zoo["name"]]
    np.testing.assert_allclose(float(loss), zoo["loss"], rtol=loss_tol)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    jgrads = dict(_flat(zoo["grads"]))
    assert len(jgrads) == len(grads)
    top = max(np.abs(g).max() for p, g in jgrads.items() if not _zero_grad(p))
    for path, want in jgrads.items():
        name, transpose = torch_name(path)
        got = grads[name].T if transpose else grads[name]
        if _zero_grad(path):
            assert np.abs(got).max() < 1e-5 * top and np.abs(want).max() < 1e-5 * top, path
            continue
        np.testing.assert_allclose(got, want, rtol=grad_tol, atol=grad_tol * np.abs(want).max(),
                                   err_msg=f"grad {path}")
    state = model.state_dict()
    for path, want in _flat(zoo["stats"]):
        got = state[torch_name(path)[0]].numpy()
        np.testing.assert_allclose(got, want, rtol=STAT_TOL, atol=STAT_TOL * np.abs(want).max(),
                                   err_msg=path)


def test_converter_names_and_refusals(zoo):
    variables = zoo["variables"]
    cls = MODELS[zoo["name"]][0]
    if zoo["name"] == "MCClass":
        assert torch_name("down_0_1/kernel_w2") == ("convs.down_0_1.kernel_w2", False)
        assert torch_name("same_mix_2/Dense_0/kernel") == ("mixes.same_mix_2.weight", True)
        assert torch_name("BatchNormReluDropout_11/MaskedBatchNorm_0/var") == (
            "bn_relus.11.bn.var", False)
        drop = "mix_1"
    else:
        assert torch_name("path_b/conv_3_4/kernel_b1") == ("path_b.convs.conv_3_4.kernel_b1",
                                                           False)
        assert torch_name("path_a/BatchNormReluDropout_2/MaskedBatchNorm_0/mean") == (
            "path_a.bn_relus.2.bn.mean", False)
        assert torch_name("joint_fc2/BatchNorm_0/scale") == ("heads.joint_fc2.bn.scale", False)
        assert torch_name("b_logits/kernel") == ("heads.b_logits.weight", True)
        drop = "joint_logits"
    partial = {"params": dict(variables["params"]), "batch_stats": variables["batch_stats"]}
    del partial["params"][drop]
    with pytest.raises(KeyError, match="left unset"):
        load_flax_variables(cls(N_CLASSES, grow=GROW), partial)
    extra = {"params": dict(variables["params"]), "batch_stats": variables["batch_stats"]}
    extra["params"]["extra_0"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(KeyError, match="no torch counterpart"):
        load_flax_variables(cls(N_CLASSES, grow=GROW), extra)


def test_predictor_and_predict_cli_serve_the_joint_head(zoo, tmp_path, capsys):
    predictor = Predictor(zoo["model"], batch_size=B)
    one = predictor.predict({"points": zoo["pts"][1:2], "mask": zoo["mask"][1:2]})
    want = zoo["want"][0] if zoo["name"] == "MCClassH" else zoo["want"]
    if zoo["name"] == "MCClassH":  # each output of the tuple, sliced back
        assert isinstance(one, tuple) and [tuple(x.shape) for x in one] == [(1, N_CLASSES)] * 3
    np.testing.assert_allclose(_joint(one).numpy(), want[1:2], rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())
    files = []
    for i in range(2):
        f = tmp_path / f"cloud{i}.npz"
        np.savez(f, points=zoo["pts"][i])
        files.append(str(f))
    records = predict_task.main([*files, "--model", zoo["name"], "--device", "cpu",
                                 "--n-classes", str(N_CLASSES), "--grow", str(GROW),
                                 "--points", "128", "--batch", "2"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == records and len(records) == 2
    assert all(r["model"] == zoo["name"] and 0 <= r["label"] < N_CLASSES for r in records)


@pytest.mark.parametrize("name,extra", [("MCClass", []), ("MCClassH", ["--protocol", "gradient"])])
def test_modelnet_cli_trains_votes_and_checkpoints(tmp_path, name, extra):
    common = ["--synthetic", "--device", "cpu", "--model", name, "--batch", "8", "--points",
              "64", "--grow", "8", "--log-dir", str(tmp_path / "logs"), "--ckpt-dir",
              str(tmp_path / "ck"), *extra]
    res = modelnet.main([*common, "--epochs", "1", "--steps-per-epoch", "2", "--votes", "2"])
    assert 0.0 <= res["best_accuracy"] <= 1.0
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["ckpt_00000002.pt"]
    with open(tmp_path / "logs" / f"modelnet_{name}.metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["tag"] == "train"]
    assert len(train) == 1 and train[0]["steps"] == 2 and np.isfinite(train[0]["loss"])
    assert [r["tag"] for r in recs].count("eval") == 1
