"""The roofline instruments of mccnn_tpu_torch against the JAX package, on the CPU:
K1p (``MCCNN_DENSE_PLANES=mxu``) and the K5 / K6 probes (``MCCNN_TILE_PROBE``).

Under ``MCCNN_DENSE_PLANES=mxu`` the reference's v2 dense forward forms its
pair planes in the factored form ``(cw_h(j) - sw_h(i)) + b1_h`` with K = 2
matmuls (``_plane_fill_mxu``); the port's K1p does the same on the tensor
cores, and its plain version is held here against the reference's
interpret-mode ``_fwd_kernel_b`` under ``_PLANES_MXU`` (a module global of
the reference, set while tracing; no JAX file changes) and against the plain
K1. Under ``MCCNN_TILE_PROBE`` the reference's tile kernels compute the
probes' values, which the port's plain versions must give: each forward probe
(``noop``, ``planes``, ``mm``), with and without packed records, and
``bwd_noop``'s gradients, with packed records, and the v1 backward, which
ignores it. The reference reads both variables while it traces; every
JAX reference of a module runs in one compiled program, and JAX's caches are
cleared around it. The kernels are held against the same plain versions on
the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.core.mcconv import MCConvParams as JParams
from mccnn_tpu.ops.pallas import dense_conv as j_dense_conv
from mccnn_tpu.ops.pallas import tile_conv as J
from mccnn_tpu_torch.core.mcconv import MCConvParams
from mccnn_tpu_torch.ops.cuda import dense_conv
from mccnn_tpu_torch.ops.cuda import tile_conv as P
from test_torch_k2 import conv_case as dense_case
from test_torch_tile_bwd import RADIUS, grad_case, jax_grads, port_grads, vjp_safe_core
from test_torch_tile_bwd import boundary_free as pairs_boundary_free

DENSE_RADIUS = 0.3
DENSE_CASES = {"depthwise": (None, False), "full_mean": (4, True)}  # c_out, mean_normalize


@contextlib.contextmanager
def environ(**values):
    """``os.environ`` under ``values`` (None unsets), restored on the way out."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def tensors(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------ K1p


@pytest.fixture(scope="module")
def jax_planes():
    """The reference's v2 dense forward in interpret mode under
    ``_PLANES_MXU``, every case in one compiled program."""
    cases = {name: dense_case(41 + k, c_out, DENSE_RADIUS, M=40)
             for k, (name, (c_out, _)) in enumerate(DENSE_CASES.items())}

    def run(arrays):
        return {name: j_dense_conv.dense_mc_conv(
            JParams(*c["params"]), c["smp"], c["qmask"], c["src"], c["smask"], c["feats"],
            c["pdf"], DENSE_RADIUS, c_out=DENSE_CASES[name][0],
            mean_normalize=DENSE_CASES[name][1], interpret=True) for name, c in arrays.items()}

    arrays = {name: {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else
                         [jnp.asarray(p) for p in v])
                     for k, v in c.items() if k != "radius"} for name, c in cases.items()}
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_dense_conv, "_PLANES_MXU", True)  # read while tracing
        out = {k: np.asarray(v) for k, v in jax.jit(run)(arrays).items()}
    jax.clear_caches()
    return cases, out


def port_dense(case, c_out, mean):
    t = {k: torch.from_numpy(v) for k, v in case.items() if isinstance(v, np.ndarray)}
    return dense_conv.dense_mc_conv(
        MCConvParams(*tensors(*case["params"])), t["smp"], t["qmask"], t["src"], t["smask"],
        t["feats"], t["pdf"], DENSE_RADIUS, c_out=c_out, mean_normalize=mean).detach().numpy()


@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_planes_plain_version_matches_jax_plane_fill_mxu(jax_planes, monkeypatch, name):
    monkeypatch.setattr(dense_conv, "_PLANES_MXU", True)
    cases, want = jax_planes
    c_out, mean = DENSE_CASES[name]
    before = (dense_conv.launches_planes, dense_conv.launches)
    got = port_dense(cases[name], c_out, mean)
    assert (dense_conv.launches_planes, dense_conv.launches) == before  # plain on the CPU
    qmask = cases[name]["qmask"][..., None]
    want = np.where(qmask, want[name], 0.0)
    scale = np.abs(want).max()
    assert scale > 0
    # 2e-2: the TPU kernel holds features and planes in bf16 (test_torch_k2.py)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * scale)


@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_planes_plain_version_matches_plain_k1(name):
    c_out, mean = DENSE_CASES[name]
    case = dense_case(51, c_out, DENSE_RADIUS, M=40)
    t = {k: torch.from_numpy(v) for k, v in case.items() if isinstance(v, np.ndarray)}
    args = (MCConvParams(*tensors(*case["params"])), t["smp"], t["qmask"], t["src"], t["smask"],
            t["feats"], t["pdf"], DENSE_RADIUS)
    kw = dict(c_out=c_out, mean_normalize=mean, with_count=True)
    got, gcnt = dense_conv.dense_mc_conv_planes_reference(*args, **kw)
    want, wcnt = dense_conv.dense_mc_conv_reference(*args, **kw)
    assert torch.equal(gcnt, wcnt)
    # 1e-5: fp32 both; cw - sw cancels O(|p| |W1| / r) terms the offset form
    # never forms, a few ulps of pre_h
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_planes_route_trains_through_the_modelnet_cli_on_the_cpu(monkeypatch, tmp_path):
    from mccnn_tpu_torch.tasks import modelnet

    monkeypatch.setattr(dense_conv, "_PLANES_MXU", True)
    calls = []
    plain = dense_conv._forward_planes_reference
    monkeypatch.setattr(dense_conv, "_forward_planes_reference",
                        lambda *a: (calls.append(1), plain(*a))[1])
    res = modelnet.main(["--synthetic", "--device", "cpu", "--epochs", "1", "--steps-per-epoch",
                         "1", "--batch", "2", "--points", "64", "--grow", "8",
                         "--log-dir", str(tmp_path), "--ckpt-dir", str(tmp_path / "ck")])
    assert calls and np.isfinite(res["best_accuracy"])


# ------------------------------------------------------------ the K5 / K6 probes

FWD_PROBES = ("noop", "planes", "mm")
PROBE_CASES = {"depthwise": (10, 8, None, 260, False), "full_mean": (22, 5, 4, 180, True)}
# (case, probe, packed records) held against the reference: noop and planes
# unpacked, mm packed on the full conv in mean mode (on the CPU the packed
# route takes the unpacked plain version, tested below, as the reference's
# packed kernels equal its unpacked ones; each reference costs a compile of
# its layout and kernel)
FWD_REFS = [("depthwise", "noop", False), ("depthwise", "planes", False),
            ("full_mean", "mm", True)]


def probe_cases():
    out = {}
    for name, (seed, c_in, c_out, M, mean) in PROBE_CASES.items():
        case = grad_case(seed, c_in, c_out, M=M)
        assert pairs_boundary_free(case)
        out[name] = (case, c_out, mean)
    return out


@pytest.fixture(scope="module")
def probe_refs():
    """One compiled program under the probes, set while tracing: the forward
    probes of ``FWD_REFS``, and the gradients of the depthwise case under
    ``bwd_noop`` with packed records (through the reference's own
    ``_core_fwd`` / ``_core_bwd``, ``vjp_safe_core``)."""
    cases = probe_cases()

    def conv(c, c_out, mean):
        return lambda prm, f: J.tile_mc_conv(prm, c["smp"], c["qmask"], c["src"], c["smask"], f,
                                             c["pdf"], RADIUS, max_pairs=1 << 30, c_out=c_out,
                                             mean_normalize=mean, interpret=True)

    @jax.jit
    def run(arrays):
        out = {}
        for name, probe, pack in FWD_REFS:
            c = arrays[name]
            _, c_out, mean = cases[name]
            with environ(MCCNN_TILE_PROBE=probe, MCCNN_TILE_PACK=str(int(pack))):
                out[f"{name} {probe} {int(pack)}"] = conv(c, c_out, mean)(JParams(*c["params"]),
                                                                          c["feats"])
        c = arrays["depthwise"]
        _, c_out, mean = cases["depthwise"]
        with environ(MCCNN_TILE_PROBE="bwd_noop", MCCNN_TILE_PACK="1"):
            out["bwd_noop pack"] = jax_grads(c, conv(c, c_out, mean))
        return out

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "_tile_conv_core", vjp_safe_core())
        want = jax.tree.map(np.asarray, run({name: c for name, (c, _, _) in cases.items()}))
    jax.clear_caches()
    return cases, want


@contextlib.contextmanager
def port_probe(probe, pack=False, v1=False):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(P, "_PROBE", probe)
        mp.setattr(P, "_PACK", pack)
        mp.setattr(P, "_BWD_V1", v1)
        yield


@pytest.mark.parametrize("name,probe,pack", FWD_REFS)
def test_forward_probe_plain_versions_match_jax_interpret(probe_refs, name, probe, pack):
    cases, want = probe_refs
    case, c_out, mean = cases[name]
    t = dict(zip(("smp", "qmask", "src", "smask", "feats", "pdf"),
                 tensors(*(case[k] for k in ("smp", "qmask", "src", "smask", "feats", "pdf")))))
    before = dict(P.launches_probe)
    with port_probe(probe, pack=pack):
        got = P.tile_mc_conv(MCConvParams(*tensors(*case["params"])), t["smp"], t["qmask"],
                             t["src"], t["smask"], t["feats"], t["pdf"], RADIUS,
                             max_pairs=1 << 30, c_out=c_out, mean_normalize=mean).numpy()
    assert P.launches_probe == before  # the plain version on the CPU
    ref = want[f"{name} {probe} {int(pack)}"]
    if probe == "noop":
        np.testing.assert_array_equal(got, 0.0)
        np.testing.assert_array_equal(ref, 0.0)
        return
    scale = np.abs(ref).max()
    assert scale > 0
    # 2e-2 of the largest output: the TPU kernel holds planes, d2 (mm, up to
    # ~3 for far valid pairs) and features in bf16
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2 * scale)
    if probe == "planes":  # one value a sample, in every channel
        np.testing.assert_array_equal(got, np.broadcast_to(got[..., :1], got.shape))


@pytest.mark.parametrize("pack", [False, True], ids=["unpacked", "packed"])
def test_bwd_noop_gives_zero_gradients_as_the_reference(probe_refs, pack):
    cases, want = probe_refs
    case, c_out, mean = cases["depthwise"]
    before = P.backward_launches_probe
    with port_probe("bwd_noop", pack=pack):
        got, _ = port_grads(case, c_out, mean)
    assert P.backward_launches_probe == before
    # the reference's packed bwd_noop (its unpacked one returns the same zeros)
    for g, w in zip(got, want["bwd_noop pack"]):
        np.testing.assert_array_equal(w, 0.0)
        np.testing.assert_array_equal(g, 0.0)
        assert g.shape == w.shape


def test_bwd_noop_leaves_the_v1_backward_as_it_is():
    # the reference's _bwd_kernel_v1 reads no probe; the port's v1 gradients
    # are held against it in test_torch_tile_variants.py
    case, c_out, mean = probe_cases()["full_mean"]
    before = P.backward_launches_probe
    with port_probe("bwd_noop", v1=True):
        got, _ = port_grads(case, c_out, mean)
    assert P.backward_launches_probe == before
    with port_probe("", v1=True):
        v1, _ = port_grads(case, c_out, mean)
    for g, w in zip(got, v1):
        assert np.abs(w).max() > 0
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("probe", FWD_PROBES)
def test_packed_probe_plain_versions_equal_the_unpacked(probe):
    # on the CPU the packed route (MCCNN_TILE_PACK) takes the probe's one
    # plain version: the records' packing is held in test_torch_tile_variants.py
    case, c_out, mean = probe_cases()["full_mean"]
    t = tensors(*(case[k] for k in ("smp", "qmask", "src", "smask", "feats", "pdf")))
    params = MCConvParams(*tensors(*case["params"]))
    before = dict(P.launches_probe)
    got = {}
    for pack in (False, True):
        with port_probe(probe, pack=pack):
            got[pack] = P.tile_mc_conv(params, *t, RADIUS, max_pairs=1 << 30, c_out=c_out,
                                       mean_normalize=mean)
    assert P.launches_probe == before
    assert torch.equal(got[True], got[False])
    assert (got[True].abs().max() > 0) == (probe != "noop")
