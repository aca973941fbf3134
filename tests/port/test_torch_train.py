"""The MCClassS training slice of mccnn_tpu_torch against the JAX package, on the CPU.

BN in training mode against flax, the optimizer against optax, dropout's
statistics, the data pipeline against the reference's numpy branch, the train
step of a small MCClassS (grow 8, B = 2 clouds of N = 128, a masked tail in
one cloud, ``drop_rate = 0``) against ``mccnn_tpu.train.make_train_step`` with
the same weights, and the CLI end to end (train, checkpoint, resume).
``neighbor_k = N`` makes the JAX model's CPU conv lossless like the port's
dense conv. Inputs come from seeded numpy generators.
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mccnn_tpu.data import datasets as j_datasets
from mccnn_tpu.models import MCClassS as JMCClassS
from mccnn_tpu.models.layers import MaskedBatchNorm as JMaskedBatchNorm
from mccnn_tpu.train import TrainState as JTrainState
from mccnn_tpu.train import accuracy as j_accuracy
from mccnn_tpu.train import classification_loss as j_classification_loss
from mccnn_tpu.train import make_optimizer as j_make_optimizer
from mccnn_tpu.train import make_train_step as j_make_train_step
from mccnn_tpu.utils import io as j_io
from mccnn_tpu_torch.convert import load_flax_train_state, load_flax_variables, torch_name
from mccnn_tpu_torch.data import datasets
from mccnn_tpu_torch.data.synthetic import classification_batch
from mccnn_tpu_torch.models import MCClassS
from mccnn_tpu_torch.models.layers import (
    Dropout,
    HeadBatchNorm,
    MaskedBatchNorm,
    set_dropout_generator,
)
from mccnn_tpu_torch.tasks import modelnet
from mccnn_tpu_torch.train import (
    accuracy,
    batch_to_device,
    classification_loss,
    init_state,
    make_optimizer,
    make_train_step,
)
from mccnn_tpu_torch.utils import io as pcio
from parity_utils import boundary_free

F32 = np.float32

# ------------------------------------------------------------------ BN


def _bn_inputs(rng, shape, masked):
    x = (rng.normal(size=shape) * 0.5 + 3.0).astype(F32)  # offset: fast vs two-pass variance
    mask = np.ones(shape[:-1], bool)
    if masked:
        mask[-1, -masked:] = False
    return x, mask


@pytest.mark.parametrize("schedule", [None, 3])
def test_masked_batchnorm_training_matches_flax(schedule):
    rng = np.random.default_rng(0)
    c = 16
    jbn = JMaskedBatchNorm(momentum=0.9, schedule_steps=schedule)
    x0, mask = _bn_inputs(rng, (2, 40, c), masked=9)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(F32),
              "bias": rng.normal(size=c).astype(F32) * 0.1}
    stats = dict(jax.tree.map(np.asarray, jbn.init(jax.random.PRNGKey(0), x0, mask, False)
                              ["batch_stats"]))
    stats["mean"] = rng.normal(size=c).astype(F32)
    stats["var"] = rng.uniform(0.5, 2.0, c).astype(F32)
    bn = MaskedBatchNorm(c, momentum=0.9, schedule_steps=schedule)
    load = {**params, **stats}
    with torch.no_grad():
        for k, v in load.items():
            getattr(bn, k).copy_(torch.tensor(np.asarray(v)))
    bn.train()
    for step in range(3):  # the schedule's count moves the momentum each step
        x = x0 * (1.0 + 0.2 * step)
        want, upd = jbn.apply({"params": params, "batch_stats": stats}, x, mask, True,
                              mutable=["batch_stats"])
        stats = jax.tree.map(np.asarray, dict(upd["batch_stats"]))
        got = bn(torch.from_numpy(x), torch.from_numpy(mask))
        # fp32 moments over 71 rows summed in another order
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        for k, v in stats.items():
            np.testing.assert_allclose(getattr(bn, k).numpy(), v, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    assert set(stats) == ({"mean", "var", "count"} if schedule else {"mean", "var"})


def test_head_batchnorm_training_matches_flax_batchnorm():
    rng = np.random.default_rng(1)
    c = 24
    x0, _ = _bn_inputs(rng, (4, c), masked=0)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = jax.tree.map(np.asarray, jbn.init(jax.random.PRNGKey(0), x0))
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(F32),
              "bias": rng.normal(size=c).astype(F32) * 0.1}
    stats = {"mean": rng.normal(size=c).astype(F32), "var": rng.uniform(0.5, 2, c).astype(F32)}
    assert set(variables["batch_stats"]) == set(stats)
    bn = HeadBatchNorm(c, momentum=0.9)
    with torch.no_grad():
        for k, v in {**params, **stats}.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    bn.train()
    for step in range(2):
        x = x0 + step
        want, upd = jbn.apply({"params": params, "batch_stats": stats}, x,
                              mutable=["batch_stats"])
        stats = jax.tree.map(np.asarray, dict(upd["batch_stats"]))
        got = bn(torch.from_numpy(x))
        # one-pass variance mean(x^2) - mean^2 at |x| ~ 3: ~1e-6 absolute rounding
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        for k, v in stats.items():
            np.testing.assert_allclose(getattr(bn, k).numpy(), v, rtol=1e-6, atol=1e-6)
    bn.eval()  # eval applies the running statistics, as flax's eval formula
    want = fnn.BatchNorm(use_running_average=True).apply(
        {"params": params, "batch_stats": stats}, x0)
    np.testing.assert_allclose(bn(torch.from_numpy(x0)).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ optimizer


@pytest.mark.parametrize("weight_decay,grad_clip", [(1e-2, None), (0.0, 0.5)])
def test_optimizer_matches_optax(weight_decay, grad_clip):
    rng = np.random.default_rng(3)
    p0 = {"a": rng.normal(size=(4, 3)).astype(F32), "b": rng.normal(size=(5,)).astype(F32)}
    grads = [{k: rng.normal(size=v.shape).astype(F32) for k, v in p0.items()}
             for _ in range(5)]
    kw = dict(lr=0.1, decay_steps=2, decay_rate=0.5, weight_decay=weight_decay,
              grad_clip=grad_clip)
    tx = j_make_optimizer(**kw)
    jp = jax.tree.map(jnp.asarray, p0)
    opt_state = tx.init(jp)
    tparams = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in ("a", "b")]
    opt = make_optimizer(tparams, **kw)
    assert [opt.schedule(s) for s in (0, 1, 2, 4)] == [0.1, 0.1, 0.05, 0.025]
    p64 = {k: v.astype(np.float64) for k, v in p0.items()}
    m64 = {k: np.zeros_like(v) for k, v in p64.items()}
    v64 = {k: np.zeros_like(v) for k, v in p64.items()}
    for t, g in enumerate(grads, 1):  # five steps cross two decay boundaries
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, k in zip(tparams, ("a", "b")):
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        g64 = {k: v.astype(np.float64) for k, v in g.items()}
        if grad_clip is not None:
            norm = np.sqrt(sum((v**2).sum() for v in g64.values()))
            g64 = {k: v / norm * grad_clip if norm >= grad_clip else v for k, v in g64.items()}
        lr = 0.1 * 0.5 ** ((t - 1) // 2)
        for p, k in zip(tparams, ("a", "b")):
            ge = g64[k] + weight_decay * p64[k]
            m64[k] = 0.9 * m64[k] + 0.1 * ge
            v64[k] = 0.999 * v64[k] + 0.001 * ge**2
            p64[k] -= lr * (m64[k] / (1 - 0.9**t)) / (np.sqrt(v64[k] / (1 - 0.999**t)) + 1e-8)
            got = p.detach().numpy()
            # optax forms its bias corrections in fp32: 1 - 0.999^t carries up
            # to 1.3e-5 relative error, about 6.5e-6 of each step of size lr
            # (0.1 here), so optax sits up to ~3e-6 from the float64 truth
            # after five steps. The port is held to both.
            np.testing.assert_allclose(got, np.asarray(jp[k]), rtol=1e-5, atol=5e-6)
            np.testing.assert_allclose(got, p64[k], rtol=1e-6, atol=1e-6)
    assert opt.count == 5


# ------------------------------------------------------------------ dropout


@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_dropout_keep_rate_scaling_seed_and_eval(rate):
    d = Dropout(rate)
    d.train()
    x = torch.ones(200, 500)
    d.generator = torch.Generator().manual_seed(7)
    y = d(x)
    kept = y != 0
    # 1e5 Bernoulli draws: the keep rate's std is below 1.6e-3; 6 sigma
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    d.generator = torch.Generator().manual_seed(7)
    assert torch.equal(d(x), y)
    d.generator = torch.Generator().manual_seed(8)
    assert not torch.equal(d(x), y)
    d.eval()
    assert torch.equal(d(x), x)


def test_model_dropout_needs_a_generator():
    pts, mask = train_inputs()
    model = MCClassS(5, grow=8, drop_rate=0.5)
    model.train()
    with pytest.raises(RuntimeError, match="generator"):
        model(torch.from_numpy(pts), torch.from_numpy(mask))
    set_dropout_generator(model, torch.Generator().manual_seed(0))
    a = model(torch.from_numpy(pts), torch.from_numpy(mask))
    set_dropout_generator(model, torch.Generator().manual_seed(0))
    b = model(torch.from_numpy(pts), torch.from_numpy(mask))
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("protocol,augment,drop", [("uniform", True, 0.3),
                                                   ("lambert", False, 0.0)])
def test_classification_batches_match_jax_numpy_branch(monkeypatch, protocol, augment, drop):
    monkeypatch.setenv("MCCNN_HOST_PIPE", "numpy")
    rng = np.random.default_rng(4)
    clouds = [rng.normal(size=(300 + 10 * i, 3)).astype(F32) for i in range(5)]
    normals = [rng.normal(size=c.shape).astype(F32) for c in clouds]
    labels = np.arange(5, dtype=np.int32)
    args = (clouds, normals, labels, [f"c{i}" for i in range(5)])
    kw = dict(train_augment=augment, protocol=protocol, pt_drop_max=drop, drop_remainder=False)
    got = list(datasets.ClassificationSource(*args).batches(2, 128, np.random.default_rng(9), **kw))
    want = list(j_datasets.ClassificationSource(*args).batches(
        2, 128, np.random.default_rng(9), **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    if drop:  # ptDropOut collapsed points onto their cloud's first: duplicates exist
        pts = np.concatenate([g["points"] for g in got])
        assert (np.abs(pts - pts[:, :1]).sum(-1) == 0).sum() > len(pts)


def test_io_reads_txt_and_ply_like_the_reference(tmp_path):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(50, 6)).astype(F32)
    for delim in (",", " "):
        f = tmp_path / f"cloud{len(delim)}.txt"
        pcio.write_points_txt(str(f), pts, delimiter=delim)
        got = pcio.read_points_txt(str(f))
        assert got.dtype == np.float32 and got.shape == (50, 6)
        np.testing.assert_array_equal(got, j_io.read_points_txt(str(f)))
    f = tmp_path / "cloud.ply"
    j_io.write_ply(str(f), pts[:, :3], colors=(rng.uniform(0, 255, (50, 3))).astype(np.uint8),
                   normals=pts[:, 3:])
    got, want = pcio.read_ply(str(f)), j_io.read_ply(str(f))
    assert list(got) == ["x", "y", "z", "nx", "ny", "nz", "red", "green", "blue"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    f = tmp_path / "ascii.ply"
    f.write_text("ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
                 "property float y\nproperty float z\nend_header\n1 2 3\n4 5 6\n")
    np.testing.assert_array_equal(pcio.read_ply(str(f))["z"], [3.0, 6.0])


# ------------------------------------------------------------------ train step

B, N, N_CLASSES, GROW = 4, 128, 6, 8
LR = dict(lr=1e-2, decay_steps=2, decay_rate=0.5)


def train_inputs():
    rng = np.random.default_rng(3)
    pts, labels = classification_batch(rng, B, N)
    pts = np.stack([datasets._normalize_np(p) for p in pts])
    mask = np.ones((B, N), bool)
    mask[1, -12:] = False
    return pts, mask


def _torch_grads(model):
    return {n: p.grad.detach().clone().numpy() for n, p in model.named_parameters()}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if hasattr(v, "items"):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


def _assert_tree_matches_model(model, tree, kind, rtol, atol_rel):
    state = model.state_dict()
    for path, want in _flat(tree):
        name, transpose = torch_name(path)
        got = state[name].detach().numpy()
        got = got.T if transpose else got
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * scale,
                                   err_msg=f"{kind} {path}")


@pytest.fixture(scope="module")
def train_case():
    pts, mask = train_inputs()
    labels = np.array([1, 4, 0, 4], np.int32)
    assert boundary_free(pts, mask, [0.1, 0.2, 0.4, 0.8])
    batch = {"points": pts, "mask": mask, "labels": labels}

    jmodel = JMCClassS(n_classes=N_CLASSES, grow=GROW, neighbor_k=N, drop_rate=0.0)
    variables = jax.jit(lambda k: jmodel.init(k, pts, mask, train=False))(
        jax.random.PRNGKey(0))
    tx = j_make_optimizer(**LR)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                         batch_stats=variables["batch_stats"],
                         opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(1))

    def loss_fn(out, b):
        return j_classification_loss(out, b["labels"]), {"acc": j_accuracy(out, b["labels"])}

    jstep = jax.jit(j_make_train_step(jmodel, tx, loss_fn))
    jbatch = jax.tree.map(jnp.asarray, batch)
    jstates, jlosses = [jstate], []
    for _ in range(3):
        jstate, m = jstep(jstate, jbatch)
        jstates.append(jstate)
        jlosses.append(float(m["loss"]))
    return dict(batch=batch, variables=jax.tree.map(np.asarray, variables),
                jstates=[jax.tree.map(np.asarray, s._asdict()) for s in jstates],
                jlosses=jlosses)


def _port_model(variables):
    model = MCClassS(N_CLASSES, grow=GROW, drop_rate=0.0)
    load_flax_variables(model, variables)
    return model


def _port_loss(out, b):
    return classification_loss(out, b["labels"]), {"acc": accuracy(out, b["labels"])}


def _adam_mu(jstate):
    return jstate["opt_state"][0][0].mu


# The head Dense biases feed a BN that subtracts the batch mean: their
# gradient is 0 up to rounding (~1e-8 here), and Adam, which normalises each
# step to about lr, turns that noise into steps of either sign. They are
# checked for that, and the head BNs' running means, which average the batch
# means the biases shift, are compared with each side's bias contributions
# taken out.
HEAD_BIASES = {"FullyConnected_0/Dense_0/bias": "FullyConnected_0/BatchNorm_0/mean",
               "FullyConnected_1/Dense_0/bias": "FullyConnected_1/BatchNorm_0/mean"}

# Tolerances of the train step, port vs JAX, both fp32 on the CPU:
# - loss: identical hierarchies (boundary-free inputs), then fp32 sums in
#   other orders through three convs, the BNs and three dense layers: 1e-5.
# - gradients: 1e-3 of each tensor's largest value (the worst seen is 2.2e-4:
#   the backward runs through batch-statistic BNs of B = 4 rows in the head).
# - parameters after the update: Adam's step is lr * m / (sqrt(v) + eps). An
#   element whose gradient is small against its rounding moves by a fraction
#   of lr (the worst seen is 0.015 lr, an element of conv_2_3's W2): 0.05 lr.
# - BN running statistics: 1e-4 of each tensor's largest value.
GRAD_TOL = 1e-3
PARAM_TOL = 0.05 * LR["lr"]
STAT_TOL = 1e-4


def _unbiased_head_means(stats, biases_used):
    """Each head BN's running mean less the momentum-weighted Dense biases
    that the batch means it averaged carried (momentum 0.9)."""
    out = {}
    for bias_path, mean_path in HEAD_BIASES.items():
        m = stats[mean_path]
        for k, b in enumerate(reversed(biases_used)):
            m = m - 0.1 * 0.9**k * b[bias_path]
        out[mean_path] = m
    return out


def _port_tree(model, tree):
    """``tree``'s leaves read from the port's model, in flax's layout."""
    state = model.state_dict()
    out = {}
    for path, _ in _flat(tree):
        name, transpose = torch_name(path)
        v = state[name].detach().numpy()
        out[path] = v.T if transpose else v
    return out


def _check_step(model, opt, jprev, jnow, grads, loss, want_loss, used):
    """``used``: (port, JAX) lists of the head biases each step ran with."""
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    # optax keeps g's running mean mu_k = 0.9 mu_(k-1) + 0.1 g_k: g_k from it
    jgrads = dict(_flat(jax.tree.map(lambda a, b: (a - 0.9 * b) / 0.1,
                                     _adam_mu(jnow), _adam_mu(jprev))))
    pgrads = {}
    for path in jgrads:
        name, transpose = torch_name(path)
        pgrads[path] = grads[name].T if transpose else grads[name]
    top = max(np.abs(g).max() for p, g in jgrads.items() if p not in HEAD_BIASES)
    for path, want in jgrads.items():
        got = pgrads[path]
        if path in HEAD_BIASES:
            assert np.abs(got).max() < 1e-6 * top and np.abs(want).max() < 1e-6 * top, path
            continue
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(want).max(), err_msg=f"grad {path}")
    port_params = _port_tree(model, jnow["params"])
    for path, want in _flat(jnow["params"]):
        if path not in HEAD_BIASES:
            np.testing.assert_allclose(port_params[path], want, rtol=0, atol=PARAM_TOL,
                                       err_msg=f"param {path}")
    port_stats = _port_tree(model, jnow["batch_stats"])
    heads = set(HEAD_BIASES.values())
    for path, want in _flat(jnow["batch_stats"]):
        if path not in heads:
            np.testing.assert_allclose(port_stats[path], want, rtol=STAT_TOL,
                                       atol=STAT_TOL * np.abs(want).max(), err_msg=path)
    got = _unbiased_head_means(port_stats, used[0])
    want = _unbiased_head_means(dict(_flat(jnow["batch_stats"])), used[1])
    for path in heads:
        np.testing.assert_allclose(got[path], want[path], rtol=STAT_TOL,
                                   atol=STAT_TOL * np.abs(want[path]).max(), err_msg=path)
    assert opt.count == int(jnow["step"])


def _head_biases(params_by_path):
    return {p: np.array(params_by_path[p]) for p in HEAD_BIASES}


def test_train_step_matches_jax(train_case):
    model = _port_model(train_case["variables"])
    opt = make_optimizer(model.parameters(), **LR)
    init_state(model, opt, seed=0)
    step = make_train_step(model, opt, _port_loss)
    batch = batch_to_device(train_case["batch"], torch.device("cpu"))
    jstates = train_case["jstates"]
    used = ([], [])
    moved = 0
    for k in range(3):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        used[0].append(_head_biases(_port_tree(model, jstates[k]["params"])))
        used[1].append(_head_biases(dict(_flat(jstates[k]["params"]))))
        loss, metrics = step(batch)
        assert set(metrics) == {"acc"}
        _check_step(model, opt, jstates[k], jstates[k + 1], _torch_grads(model),
                    float(loss), train_case["jlosses"][k], used)
        moved += sum(not torch.equal(before[n], p) for n, p in model.named_parameters())
    assert moved == 3 * len(before)  # every parameter took every step


def test_one_step_from_a_carried_over_jax_state(train_case):
    j2, j3 = train_case["jstates"][2], train_case["jstates"][3]
    model = MCClassS(N_CLASSES, grow=GROW, drop_rate=0.0)
    opt = make_optimizer(model.parameters(), **LR)
    state = init_state(model, opt, seed=0)
    adam = j2["opt_state"][0][0]
    load_flax_train_state(state, {"params": j2["params"], "batch_stats": j2["batch_stats"],
                                  "mu": adam.mu, "nu": adam.nu, "count": adam.count,
                                  "step": j2["step"]})
    assert state.step == 2
    _assert_tree_matches_model(model, j2["params"], "params", 0, 0)
    step = make_train_step(model, opt, _port_loss)
    loss, _ = step(batch_to_device(train_case["batch"], torch.device("cpu")))
    used = [_head_biases(dict(_flat(j2["params"])))]
    _check_step(model, opt, j2, j3, _torch_grads(model), float(loss), train_case["jlosses"][2],
                (used, used))


# ------------------------------------------------------------------ the CLI


def test_modelnet_cli_trains_checkpoints_and_resumes(tmp_path):
    common = ["--synthetic", "--device", "cpu", "--steps-per-epoch", "2", "--batch", "2",
              "--points", "64", "--grow", "8", "--log-dir", str(tmp_path / "logs"),
              "--ckpt-dir", str(tmp_path / "ck")]
    res = modelnet.main([*common, "--epochs", "1"])
    assert 0.0 <= res["best_accuracy"] <= 1.0
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["ckpt_00000002.pt"]
    modelnet.main([*common, "--epochs", "3", "--resume", "--eval-every", "10",
                   "--profile-dir", str(tmp_path / "prof")])
    with open(tmp_path / "logs" / "modelnet_MCClassS.metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["tag"] == "train"]
    # resumed at step 2, epoch 1; the run's second epoch is the profiled one
    assert [(r["epoch"], r["step"]) for r in train] == [(0, 2), (1, 4), (2, 6)]
    assert all(np.isfinite(r["loss"]) and r["steps"] == 2 and r["warm_step_ms"] > 0
               for r in train)
    assert [r["tag"] for r in recs].count("eval") == 1
    assert sorted(p.name for p in (tmp_path / "prof").iterdir()) == ["ops.txt", "trace.json"]
    assert "self_cpu_time_total" in (tmp_path / "prof" / "ops.txt").read_text()
    if not torch.cuda.is_available():  # --device defaults to cuda and never falls back
        with pytest.raises(RuntimeError, match="no CUDA device"):
            modelnet.main([a for a in common if a not in ("--device", "cpu")] + ["--epochs", "1"])
