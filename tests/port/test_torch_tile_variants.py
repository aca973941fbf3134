"""The reference's tile switches in mccnn_tpu_torch against the JAX package, on the CPU.

``MCCNN_TILE_ORDER=morton``, ``MCCNN_TILE_ADJ=aabb``, ``MCCNN_TILE_MINOR``,
``MCCNN_TILE_PACK=1`` and ``MCCNN_TILE_BWD_V1=1`` change what the reference's
tile conv, KDE and cover sweep build and run. The port reads them once into
module constants (``tile_conv._ORDER`` ...); here each test sets both the
environment, which the reference reads while it traces (so every JAX
reference below is traced anew under its setting), and the port's constants.

The host machinery (orders, adjacencies, both step lists, step and pair
counts, the capacity sizing, the cover sweep's list) must equal the JAX
package's exactly under each setting. The plain versions of the tile conv,
K7 and K8 at other minor sizes, of K5p / K6p (packed records) and of K6v1
(the per-h backward) are held against the reference's Pallas kernels in
interpret mode, which hold features in bf16 (rtol 2e-2); each setting's
interpret-mode references run in one compiled program. The kernels are held
against the same plain versions on the card (``test_torch_cuda.py`` and
``chip_smoke.py``).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.core.mcconv import MCConvParams as JParams
from mccnn_tpu.models import MCSeg as JMCSeg
from mccnn_tpu.ops.pallas import tile_conv as J
from mccnn_tpu_torch.core.mcconv import MCConvParams
from mccnn_tpu_torch.ops.cuda import tile_conv as P
from parity_utils import boundary_free
from test_torch_mcseg import _flax_from_torch, _inputs, _port_model, _seed_statistics
from test_torch_tile import RADII, T, cloud, conv_case
from test_torch_tile_bwd import (RADIUS, assert_grads_close, grad_case, jax_grads, port_grads,
                                 vjp_safe_core)
from test_torch_tile_bwd import boundary_free as pairs_boundary_free

# switch -> (environment variable, the port's module constant)
SWITCHES = {"order": ("MCCNN_TILE_ORDER", "_ORDER"), "adj": ("MCCNN_TILE_ADJ", "_ADJ"),
            "minor": ("MCCNN_TILE_MINOR", "_MINOR"), "pack": ("MCCNN_TILE_PACK", "_PACK"),
            "v1": ("MCCNN_TILE_BWD_V1", "_BWD_V1")}


@contextlib.contextmanager
def switches(**settings):
    """Both packages under the same tile switches."""
    with pytest.MonkeyPatch.context() as mp:
        for key, value in settings.items():
            var, attr = SWITCHES[key]
            mp.setenv(var, value)
            mp.setattr(P, attr, value == "1" if key in ("pack", "v1") else value)
        yield


@contextlib.contextmanager
def traced_under(**settings):
    """``switches`` for JAX references traced inside: JAX's caches are cleared
    on the way in and out, so that a trace cached under one setting serves no
    other."""
    jax.clear_caches()
    try:
        with switches(**settings):
            yield
    finally:
        jax.clear_caches()


def tensors(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------ host machinery


@pytest.mark.parametrize("seed", [0, 3])
def test_morton_order_matches_jax(seed):
    pts, mask = cloud(seed)
    want = np.asarray(jax.jit(J.morton_order)(pts, mask))
    tp, tm = tensors(pts, mask)
    np.testing.assert_array_equal(P.morton_order(tp, tm).numpy(), want)
    assert not np.array_equal(want, np.asarray(jax.jit(J.hilbert_order)(pts, mask)))
    with switches(order="morton"):
        np.testing.assert_array_equal(P.curve_order(tp, tm).numpy(), want)


HOST_SETTINGS = {
    "aabb_minor8": dict(adj="aabb", minor="8"),
    "minor16": dict(minor="16"),
    "minor128": dict(minor="128"),
    "morton_aabb_minor64": dict(order="morton", adj="aabb", minor="64"),
}


def _jax_host(smp, qm, src, sm, radius):
    """Under the current environment, traced: JAX's adjacency, forward and
    backward step lists and their demand as its ``tile_mc_conv`` builds them
    (``tile_conv.py:1286-1349``, the backward adjacency transposed at Tm ==
    T), which ``count_tile_steps`` (``:466-473``) and ``count_tile_pairs``
    (``:435-443``) reduce, and the cover sweep's list (``make_cover_sweep``),
    whose real steps are the self demand ``auto_tile_pairs`` sizes from."""
    Tm = J.tile_minor(T)
    Gm = J.DEFAULT_CHUNK * (T // Tm)
    M, N = smp.shape[1], src.shape[1]
    nts, ntp, nts_m, ntp_m = -(-M // T), -(-N // T), -(-M // Tm), -(-N // Tm)
    S = max(J._steps_for_pairs(nts * ntp_m, Gm, nts, ntp_m),
            J._steps_for_pairs(ntp * nts_m, Gm, ntp, nts_m))
    order_s, order_p = J.curve_order(smp, qm), J.curve_order(src, sm)
    sr, _, mn_i, mx_i = J._sorted_tiles(smp, qm, order_s, T, nts * T)
    pr, _, mn_j, mx_j = J._sorted_tiles(src, sm, order_p, T, ntp * T)
    srm, _, mn_im, mx_im = J._sorted_tiles(smp, qm, order_s, Tm, nts_m * Tm)
    prm, _, mn_jm, mx_jm = J._sorted_tiles(src, sm, order_p, Tm, ntp_m * Tm)
    adj_f = J._refined_adjacency(sr, mn_i, mx_i, prm, mn_jm, mx_jm, T, radius, Tm)
    adj_b = (jnp.swapaxes(adj_f, 1, 2) if Tm == T else
             J._refined_adjacency(pr, mn_j, mx_j, srm, mn_im, mx_im, T, radius, Tm))
    i_ids, j_ids = J._chunked_pair_lists(adj_f, S, Gm, nts - 1, ntp_m)
    jb_ids, ib_ids = J._chunked_pair_lists(adj_b, S, Gm, ntp - 1, nts_m)
    need = jnp.maximum(J._needed_steps(adj_f, Gm), J._needed_steps(adj_b, Gm))
    sweep = J.make_cover_sweep(src, sm, radius, max_pairs=1 << 30)
    pairs = jnp.maximum(adj_f.sum((1, 2)), adj_b.sum((1, 2)))
    self_steps = jnp.any(sweep.j_ids != sweep.spec.NTp, axis=1).sum(-1)
    return Tm, S, (adj_f, i_ids, j_ids, jb_ids, ib_ids, need, sweep.i_ids, sweep.j_ids, pairs,
                   self_steps)


HOST_RADIUS = RADII[1]


def host_clouds():
    return (*cloud(4, N=300, masked=25), *cloud(5, N=500, masked=60))


@pytest.fixture(scope="module")
def host_refs():
    """``_jax_host`` under every setting of ``HOST_SETTINGS``, in one compiled
    program: each setting's part is traced with its environment set."""
    statics = {}

    def all_settings(*clouds):
        out = {}
        for name, setting in HOST_SETTINGS.items():
            with switches(**setting):
                Tm, S, out[name] = _jax_host(*clouds, HOST_RADIUS)
            statics[name] = Tm, S
        return out

    jax.clear_caches()
    refs = jax.jit(all_settings)(*host_clouds())
    jax.clear_caches()
    return {name: (*statics[name], [np.asarray(a) for a in refs[name]]) for name in refs}


@pytest.mark.parametrize("setting", list(HOST_SETTINGS))
def test_layouts_step_lists_and_counts_match_jax_under_each_switch(host_refs, setting):
    smp, qm, src, sm = host_clouds()
    ts, tq, tsrc, tsm = tensors(smp, qm, src, sm)
    radius = HOST_RADIUS
    Tm, S, (adj, i_ids, j_ids, jb_ids, ib_ids, need, sw_i, sw_j, pairs,
            self_steps) = host_refs[setting]
    with switches(**HOST_SETTINGS[setting]), pytest.MonkeyPatch.context() as mp:
        lay = P.conv_layout(ts, tq, tsrc, tsm, radius, max_pairs=1 << 30, backward=True)
        assert lay.steps.Tm == lay.steps_b.Tm == Tm and lay.S == S
        np.testing.assert_array_equal(P._count_adjacency(ts, tq, tsrc, tsm, radius, T, Tm).numpy(),
                                      adj)
        for st, major, minors in ((lay.steps, i_ids, j_ids), (lay.steps_b, jb_ids, ib_ids)):
            np.testing.assert_array_equal(st.i_ids.numpy(), major)
            np.testing.assert_array_equal(st.j_ids.numpy(), minors)
        np.testing.assert_array_equal((lay.overflow + lay.S).numpy(), np.maximum(need, S))
        np.testing.assert_array_equal(P.count_tile_steps(ts, tq, tsrc, tsm, radius).numpy(), need)
        np.testing.assert_array_equal(P.count_tile_pairs(ts, tq, tsrc, tsm, radius).numpy(), pairs)
        # the reference's sizing arithmetic on its own (compiled) self demand:
        # one point set's two list directions are one adjacency, the cover
        # sweep's (the same tiles, minors and chunk)
        mp.setattr(J, "count_tile_steps", lambda *args: self_steps)
        assert P.auto_tile_pairs(tsrc, tsm, radius) == J.auto_tile_pairs(src, sm, radius)
        sweep = P.make_cover_sweep(tsrc, tsm, radius, max_pairs=1 << 30)
        np.testing.assert_array_equal(sweep.layout.steps.i_ids.numpy(), sw_i)
        np.testing.assert_array_equal(sweep.layout.steps.j_ids.numpy(), sw_j)
    assert adj.sum() > 0 and need.min() > 0


# ------------------------------------------------------------ K5, K7, K8 at another layout

CONV_RADIUS = 0.25
CHILD = dict(order="morton", adj="aabb", minor="64")  # a chip_smoke.py child trainer


def jax_interpret_conv(case, c_out=None):
    """JAX's tile conv in interpret mode on ``case``, traced in the caller's jit."""
    smp, qmask, src, smask, feats, pdf, params = case
    return J.tile_mc_conv(JParams(*map(jnp.asarray, params)), smp, qmask, src, smask, feats,
                          pdf, CONV_RADIUS, max_pairs=1 << 30, c_out=c_out, interpret=True)


@pytest.fixture(scope="module")
def child_refs():
    """Under Morton order, box-only adjacency and ``MCCNN_TILE_MINOR=64``, one
    compiled program: the interpret-mode tile conv, tile KDE and cover counts
    (random flags over the sweep's rows, on ``test_torch_tile.py``'s
    boundary-free sampler cloud)."""
    conv = conv_case(10, 8, None, M=260)
    pts, mask = cloud(12, N=400)
    cpts, cmask = cloud(15, N=500, masked=35)
    assert boundary_free(cpts, cmask, [0.1])
    with traced_under(**CHILD):
        sweep = P.make_cover_sweep(*tensors(cpts, cmask), 0.1, max_pairs=1 << 30)
        valid = sweep.valid.numpy()
        flags = valid & (np.random.default_rng(14).uniform(size=valid.shape) < 0.3)

        @jax.jit
        def refs(p, m, cp, cm, f):
            jsweep = J.make_cover_sweep(cp, cm, 0.1, max_pairs=1 << 30, interpret=True)
            return (jax_interpret_conv(conv), J.tile_kde(p, m, 0.2, max_pairs=1 << 30,
                                                         interpret=True),
                    jsweep.counts(f))

        out = [np.asarray(a) for a in refs(pts, mask, cpts, cmask, flags.astype(np.float32))]
    return dict(conv=conv, pts=pts, mask=mask, cpts=cpts, cmask=cmask, flags=flags, want=out)


def port_conv(case, c_out=None):
    smp, qmask, src, smask, feats, pdf, params = case
    return P.tile_mc_conv(MCConvParams(*tensors(*params)), *tensors(smp, qmask, src, smask, feats,
                                                                    pdf),
                          CONV_RADIUS, max_pairs=1 << 30, c_out=c_out).numpy()


def test_tile_conv_plain_matches_jax_interpret_under_morton_aabb_minor_64(child_refs):
    with switches(**CHILD):
        got = port_conv(child_refs["conv"])
    want = child_refs["want"][0]
    assert np.abs(want).max() > 0
    # rtol 2e-2: the Pallas kernel holds features and planes in bf16
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


def test_tile_kde_and_cover_counts_at_minor_64_match_jax(child_refs):
    r = child_refs
    pts, mask = tensors(r["pts"], r["mask"])
    with switches(**CHILD):
        kde = P.tile_kde(pts, mask, 0.2, max_pairs=1 << 30).numpy()
        sweep = P.make_cover_sweep(*tensors(r["cpts"], r["cmask"]), 0.1, max_pairs=1 << 30)
        assert sweep.layout.steps.Tm == 64
        counts = sweep.counts(torch.from_numpy(r["flags"])).numpy()
    # rtol 1e-4: the JAX self-pair d2 is not 0 (ROADMAP queue 3), fp32 sums
    np.testing.assert_allclose(kde, r["want"][1], rtol=1e-4)
    valid = sweep.valid.numpy()
    np.testing.assert_array_equal(counts[valid], r["want"][2][valid].astype(np.int32))
    assert counts[valid].max() > 1


# ------------------------------------------------------------ K6v1 and K5p / K6p


def jax_interpret_grads(cases, c_outs):
    """``jax.grad`` of each case's tile conv in interpret mode (the
    reference's own ``_core_fwd`` / ``_core_bwd`` through ``vjp_safe_core``),
    one compiled program under the current environment."""

    @jax.jit
    def run(cs):
        out = []
        for c, c_out in zip(cs, c_outs):
            conv = (lambda prm, f, c=c, c_out=c_out: J.tile_mc_conv(
                prm, c["smp"], c["qmask"], c["src"], c["smask"], f, c["pdf"], RADIUS,
                max_pairs=1 << 30, c_out=c_out, interpret=True))
            out.append(jax_grads(c, conv))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "_tile_conv_core", vjp_safe_core())
        return run(cases)


GRAD_CASES = {"depthwise": (10, 8, None, 260), "full": (22, 5, 4, 180)}  # seed, c_in, c_out, M


def grad_cases():
    out = {}
    for name, (seed, c_in, c_out, M) in GRAD_CASES.items():
        case = grad_case(seed, c_in, c_out, M=M)
        assert pairs_boundary_free(case)
        out[name] = (case, c_out)
    return out


@pytest.fixture(scope="module")
def v1_refs():
    """The reference's v1 backward (``MCCNN_TILE_BWD_V1=1``) in interpret mode
    on the depthwise case."""
    case, c_out = grad_cases()["depthwise"]
    with traced_under(v1="1"):
        return jax_interpret_grads([case], [c_out])[0]


@pytest.fixture(scope="module")
def pack_refs():
    """The reference's packed records (``MCCNN_TILE_PACK=1``) in interpret mode."""
    case, c_out = grad_cases()["depthwise"]
    with traced_under(pack="1"):
        grads = jax_interpret_grads([case], [c_out])[0]
    return case, grads


def test_v1_backward_plain_matches_jax_v1(v1_refs):
    case, c_out = grad_cases()["depthwise"]
    with switches(v1="1"):
        got, ovf = port_grads(case, c_out, False)
    assert (ovf == 0).all()
    # rtol 2e-2: the reference's v1 kernel holds the features in bf16
    assert_grads_close(got, v1_refs, 2e-2)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_v1_backward_plain_matches_plain_k6(name):
    # the full case is the stem's form (t_h = t . W2_h^T); the plain K6 is
    # held against the JAX package in test_torch_tile_bwd.py
    case, c_out = grad_cases()[name]
    with switches(v1="1"):
        got, _ = port_grads(case, c_out, False)
    k6, _ = port_grads(case, c_out, False)
    # both plain versions in fp32, the sums in other orders
    assert_grads_close(got, k6, 1e-5)


def test_packed_plain_path_is_bit_equal_and_matches_jax_packed(pack_refs):
    case, want = pack_refs
    with switches(pack="1"):
        got, _ = port_grads(case, None, False)
        out = port_conv((case["smp"], case["qmask"], case["src"], case["smask"], case["feats"],
                         case["pdf"], case["params"]))
    unpacked, _ = port_grads(case, None, False)
    for name, a, b in zip(("dw1", "db1", "dw2", "db2", "dfeatures"), got, unpacked):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(out, port_conv((case["smp"], case["qmask"], case["src"],
                                                  case["smask"], case["feats"], case["pdf"],
                                                  case["params"])))
    assert_grads_close(got, want, 2e-2)


# ------------------------------------------------------------ routing


@pytest.mark.parametrize("pack,v1,forward,backward", [
    ("0", "0", (False, "cpu"), "K6"), ("1", "0", (True, "cpu"), "K6p"),
    ("0", "1", (False, "cpu"), "K6v1"), ("1", "1", (False, "cpu"), "K6v1")])
def test_switches_route_the_plain_versions(monkeypatch, pack, v1, forward, backward):
    calls = []

    def spy(table, key):
        fn = table[key]
        monkeypatch.setitem(table, key, lambda *a, **k: (calls.append(key), fn(*a, **k))[1])

    for key in list(P._FORWARDS):
        spy(P._FORWARDS, key)
    for key in list(P._BACKWARDS):
        spy(P._BACKWARDS, key)
    smp, qmask, src, smask, feats, pdf, params = conv_case(11, 3, None, M=100, N=200)
    prm = MCConvParams(*(t.requires_grad_() for t in tensors(*params)))
    with switches(pack=pack, v1=v1):
        P.tile_mc_conv(prm, *tensors(smp, qmask, src, smask, feats, pdf), 0.3,
                       max_pairs=1 << 30).square().sum().backward()
    assert calls == [forward, (backward, "cpu")]


@pytest.mark.parametrize("minor", ["24", "256", "4", "x"])
def test_a_bad_minor_size_raises_in_both_packages(minor):
    pts, mask = tensors(*cloud(1, N=200))
    with switches(minor=minor):
        with pytest.raises(ValueError):
            P.conv_layout(pts, mask, pts, mask, 0.2, max_pairs=1 << 30)
        with pytest.raises((AssertionError, ValueError)):
            J.tile_minor(T)


def test_an_unknown_roofline_probe_raises():
    # the reference runs the conv under a value that is none of its probes
    # (ROADMAP queue 3); the port refuses it
    smp, qmask, src, smask, feats, pdf, params = conv_case(11, 3, None, M=100, N=200)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(P, "_PROBE", "bwd-noop")
        with pytest.raises(ValueError, match="MCCNN_TILE_PROBE"):
            P.tile_mc_conv(MCConvParams(*tensors(*params)),
                           *tensors(smp, qmask, src, smask, feats, pdf), 0.3, max_pairs=1 << 30)


# ------------------------------------------------------------ the slice: MCSeg


def test_mcseg_under_morton_aabb_minor_64_matches_jax():
    """One small MCSeg (``test_torch_mcseg.py``'s) with every conv on the tile
    path under the child trainer's switches, against the JAX MCSeg under the
    same environment (its CPU path, the lossless K-capacity conv)."""
    pts, mask = _inputs()
    jmodel = JMCSeg(n_classes=5, grow=8, radii=(0.2, 0.4), neighbor_k=pts.shape[1])
    with traced_under(order="morton", adj="aabb", minor="64"):
        shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), pts, mask,
                                                    train=False))
        template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
        seeded = _port_model("tile")
        _seed_statistics(seeded, pts, mask, np.random.default_rng(6))
        variables = _flax_from_torch(seeded, template)
        want = np.asarray(jax.jit(lambda v: jmodel.apply(v, pts, mask, train=False))(variables))
        model = _port_model("tile", variables)
        with torch.inference_mode():
            got, overflow = model(*tensors(pts, mask), with_overflow=True)
    assert int(overflow) == 0 and np.abs(want).max() > 0.1
    # the tolerance of test_torch_mcseg.py's logits: fp32 sums in other orders
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
