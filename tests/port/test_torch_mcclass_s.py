"""The MCClassS serving slice of mccnn_tpu_torch against the flax model, on the CPU.

One small model (grow=8, B=2 clouds of N=256 points, a masked tail in one
cloud) is built once per module in both packages with the same weights and
seeded, non-trivial BN statistics. ``neighbor_k = N`` makes the JAX model's CPU
conv (the K-capacity jnp path) lossless like the dense kernel the port runs.
"""

import copy
import json

import jax
import numpy as np
import pytest
import torch

from mccnn_tpu.api.hierarchy import build_hierarchy as j_build_hierarchy
from mccnn_tpu.models import MCClassS as JMCClassS
from mccnn_tpu_torch.api.hierarchy import build_hierarchy
from mccnn_tpu_torch.convert import load_flax_variables, load_npz_variables, torch_name
from mccnn_tpu_torch.data.datasets import _normalize_np
from mccnn_tpu_torch.data.synthetic import classification_batch
from mccnn_tpu_torch.models import MCClassS
from mccnn_tpu_torch.models.layers import MaskedBatchNorm, MCConv, set_dropout_generator
from mccnn_tpu_torch.serve import Predictor, make_predict_fn
from mccnn_tpu_torch.tasks import predict as predict_task
from parity_utils import boundary_free

B, N, N_CLASSES, GROW = 2, 256, 10, 8
RADII = (0.1, 0.4)
SEED = 2


def _inputs():
    rng = np.random.default_rng(SEED)
    pts, _ = classification_batch(rng, B, N)
    pts = np.stack([_normalize_np(p) for p in pts])
    mask = np.ones((B, N), bool)
    mask[1, -24:] = False
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
    """Seeded BN statistics near each BN input's moments, seeded BN affine
    parameters and conv biases: every term of the forward is exercised."""
    predict = make_predict_fn(model)
    args = (torch.from_numpy(pts), torch.from_numpy(mask))
    with torch.no_grad():
        for conv in [m for m in model.modules() if isinstance(m, MCConv)]:
            conv.kernel_b1.copy_(torch.from_numpy(rng.normal(size=conv.kernel_b1.shape) * 0.1))
            conv.kernel_b2.copy_(torch.from_numpy(rng.normal(size=conv.kernel_b2.shape) * 0.1))
    for bn in [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]:
        seen = []
        hook = bn.register_forward_pre_hook(lambda mod, inp: seen.append(inp[0].clone()))
        predict(*args)
        hook.remove()
        x = seen[0].reshape(-1, seen[0].shape[-1]).double()
        c = x.shape[-1]
        # The RMS, not the std, sets the scale: the global level and the head
        # see only B rows, and a std over two rows would amplify rounding.
        mean, rms = x.mean(0), x.square().mean(0).sqrt().clamp_min(1e-3)
        with torch.no_grad():
            bn.mean.copy_(mean + 0.1 * rms * torch.from_numpy(rng.normal(size=c)))
            bn.var.copy_(rms**2 * torch.from_numpy(rng.uniform(0.5, 1.5, size=c)))
            bn.scale.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, size=c)))
            bn.bias.copy_(torch.from_numpy(rng.normal(size=c) * 0.1))


@pytest.fixture(scope="module")
def case():
    pts, mask = _inputs()
    jmodel = JMCClassS(n_classes=N_CLASSES, grow=GROW, radii=RADII, neighbor_k=N)
    # init and apply each compiled as one program (op by op they take ~20 s)
    template = jax.tree_util.tree_map(np.asarray, dict(jax.jit(
        lambda k: jmodel.init(k, pts, mask, train=False))(jax.random.PRNGKey(0))))
    seeded = MCClassS(N_CLASSES, grow=GROW, radii=RADII)
    load_flax_variables(seeded, template)
    _seed_statistics(seeded, pts, mask, np.random.default_rng(SEED))
    variables = _flax_from_torch(seeded, template)

    model = MCClassS(N_CLASSES, grow=GROW, radii=RADII)
    load_flax_variables(model, variables)  # the port's weights come through the converter
    want = np.asarray(jax.jit(lambda v: jmodel.apply(v, pts, mask, train=False))(variables))
    got = make_predict_fn(model)(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    return dict(pts=pts, mask=mask, model=model, variables=variables, want=want, got=got)


def test_inputs_are_boundary_free(case):
    # exact hierarchy equality is claimed only away from every radius the
    # slice tests (Poisson 0.1 / 0.4, conv and KDE 0.2 / 0.8)
    assert boundary_free(case["pts"], case["mask"], [0.1, 0.2, 0.4, 0.8])


def test_hierarchy_matches_jax(case):
    pts, mask = case["pts"], case["mask"]
    want = jax.jit(lambda p, m: j_build_hierarchy(p, m, RADII, neighbor_k=N,
                                                  global_level=True))(pts, mask)
    got = build_hierarchy(torch.from_numpy(pts), torch.from_numpy(mask), RADII,
                          global_level=True)
    assert len(got) == len(want) == 4
    for g, w in zip(got.levels[1:3], want.levels[1:3]):
        np.testing.assert_array_equal(g.sample.idx.numpy(), np.asarray(w.sample.idx))
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
        np.testing.assert_array_equal(g.points.numpy(), np.asarray(w.points))
        assert g.mask.sum() > 0 and (~g.mask).sum() > 0  # both real and padded slots
    g, w = got.levels[3], want.levels[3]
    np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
    # the global centroid: fp32 sums over the level in another order
    np.testing.assert_allclose(g.points.numpy(), np.asarray(w.points), rtol=1e-6, atol=1e-7)


def test_logits_match_jax(case):
    want, got = case["want"], case["got"]
    assert got.shape == (B, N_CLASSES) and np.isfinite(got).all()
    assert np.abs(want).max() > 0.1  # the seeded statistics give non-trivial logits
    # rtol 1e-3 / atol 1e-3 * max|logit|: identical hierarchies, then fp32
    # sums in other orders through three convs, the KDE's d2 rounding
    # (see test_torch_kernels.py) and three dense layers.
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_predictor_pads_a_small_request(case):
    predictor = Predictor(case["model"], batch_size=B)
    one = predictor.predict({"points": case["pts"][1:], "mask": case["mask"][1:]})
    assert tuple(one.shape) == (1, N_CLASSES)
    want = case["want"][1:]
    np.testing.assert_allclose(one.numpy(), want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    with pytest.raises(ValueError, match="exceeds the serving batch"):
        predictor.predict({"points": np.concatenate([case["pts"]] * 2),
                           "mask": np.concatenate([case["mask"]] * 2)})


def test_predict_fn_is_eval_and_inference_mode(case):
    model = copy.deepcopy(case["model"])
    args = (torch.from_numpy(case["pts"]), torch.from_numpy(case["mask"]))
    bn = model.bn_relus[0].bn
    running = bn.mean.clone()
    model.train()
    out = make_predict_fn(model)(*args)
    assert not model.training and out.is_inference()
    assert torch.equal(bn.mean, running)  # eval mode reads the running statistics
    np.testing.assert_allclose(out.numpy(), case["want"], rtol=1e-3,
                               atol=1e-3 * np.abs(case["want"]).max())
    model.train()  # training mode: batch moments, and the running statistics move
    set_dropout_generator(model, torch.Generator().manual_seed(0))
    logits = model(*args)
    assert logits.requires_grad and bool(torch.isfinite(logits).all())
    assert not torch.equal(bn.mean, running)


def test_converter_refuses_partial_or_extra_leaves(case):
    variables = case["variables"]
    partial = {"params": dict(variables["params"]), "batch_stats": variables["batch_stats"]}
    del partial["params"]["logits"]
    with pytest.raises(KeyError, match="left unset"):
        load_flax_variables(MCClassS(N_CLASSES, grow=GROW), partial)
    extra = {"params": dict(variables["params"]), "batch_stats": variables["batch_stats"]}
    extra["params"]["extra_0"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(KeyError, match="no torch counterpart"):
        load_flax_variables(MCClassS(N_CLASSES, grow=GROW), extra)


def test_predict_cli_serves_npz_weights(case, tmp_path, capsys):
    flat = {}
    for coll in ("params", "batch_stats"):
        stack = [(coll, case["variables"][coll])]
        while stack:
            prefix, tree = stack.pop()
            for k, v in tree.items():
                if hasattr(v, "items"):
                    stack.append((f"{prefix}/{k}", v))
                else:
                    flat[f"{prefix}/{k}"] = v
    weights = tmp_path / "w.npz"
    np.savez(weights, **flat)
    loaded = load_npz_variables(str(weights))
    assert torch_name("logits/kernel") == ("logits.weight", True)
    np.testing.assert_array_equal(loaded["params"]["logits"]["kernel"],
                                  case["variables"]["params"]["logits"]["kernel"])
    files = []
    for i in range(3):  # three files: one full batch of 2, then a padded batch of 1
        f = tmp_path / f"cloud{i}.npz"
        np.savez(f, points=case["pts"][i % B] * 5.0 + 1.0)  # the CLI re-normalizes
        files.append(str(f))
    records = predict_task.main([
        *files, "--weights", str(weights), "--device", "cpu", "--n-classes",
        str(N_CLASSES), "--grow", str(GROW), "--points", str(N), "--batch", str(B),
    ])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines == records and len(records) == 3
    for rec in records:
        assert 0 <= rec["label"] < N_CLASSES and rec["top5"][0][0] == rec["label"]
        probs = [p for _, p in rec["top5"]]
        assert probs == sorted(probs, reverse=True) and 0 < rec["prob"] <= 1
