"""The z-order tile machinery and the plain versions of K5, K7 and K8 against
the JAX package, on the CPU.

The host machinery (Hilbert order, tile boxes, refined adjacency, chunked
step lists, pair and step counts, capacity sizing) is integer and boolean
code and must equal the JAX package's exactly. The plain versions of the tile
conv (K5), the tile KDE (K7) and the cover count (K8) are held against the
JAX lossless references (the K-capacity conv with k = N, the dense KDE, the
dense sampler) and against the Pallas tile kernels in interpret mode, which
cost a compile each, so those cases are few (the tile sampler's 27 cover
queries and one query with random flags share one compiled program, and the
host tests share their radii and shapes). The CUDA kernels are held
against the same plain versions on the card (``test_torch_cuda.py`` and
``chip_smoke.py``). Inputs come from a seeded numpy generator and include
masked points.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.api import hierarchy as jhierarchy
from mccnn_tpu.core import mc_conv, radius_neighbors
from mccnn_tpu.core import sampling as jsampling
from mccnn_tpu.core.grid import cell_color27, cell_coords, grid_res_for_radius, linear_cell_ids
from mccnn_tpu.core.mcconv import MCConvParams as JParams
from mccnn_tpu.core.pdf import kde_density as j_kde_density
from mccnn_tpu.models import MCSeg as JMCSeg
from mccnn_tpu.ops.pallas import tile_conv as J
from mccnn_tpu.tasks.common import auto_tile_steps as j_auto_tile_steps
from mccnn_tpu_torch.core import sampling
from mccnn_tpu_torch.core.mcconv import MCConvParams
from mccnn_tpu_torch.models import MCSeg
from mccnn_tpu_torch.ops.cuda import tile_conv as P
from mccnn_tpu_torch.ops.cuda.poisson_kernel import poisson_sweep_reference
from mccnn_tpu_torch.tasks.common import auto_tile_steps
from parity_utils import boundary_free

T, TM, GM = 128, 32, 32
# the host-machinery tests share these radii and the clouds' shapes, so the
# JAX programs they compile are compiled once for the module
RADII = (0.1, 0.25)


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_adjacency():
    """JAX's adjacency helpers and ``build_hierarchy`` under ``jax.jit`` while
    this module runs: the same functions, compiled once per shape instead of
    op by op (the JAX counters, ``auto_tile_pairs``, ``auto_tile_steps`` and
    the sampler's step count reach them through their modules)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "_count_adjacency",
                   jax.jit(J._count_adjacency, static_argnums=(4, 5, 6)))
        mp.setattr(J, "_refined_adjacency",
                   jax.jit(J._refined_adjacency, static_argnums=(6, 7, 8)))
        eager_hierarchy = jhierarchy.build_hierarchy
        mp.setattr(jhierarchy, "build_hierarchy", lambda p, m, radii, **kw: jax.jit(
            lambda p, m: eager_hierarchy(p, m, radii, **kw))(p, m))
        yield


def cloud(seed, B=2, N=500, masked=40):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, size=(B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[-1, N - masked:] = False
    return pts, mask


def both(*arrays):
    """(jax arrays, torch tensors) of the same numpy arrays."""
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def jax_step_lists(smp, qm, src, sm, radius, max_pairs, max_steps=None):
    """The forward and backward step lists, budget and overflow exactly as
    JAX's ``tile_mc_conv`` derives them (``tile_conv.py:1265-1342``)."""
    M, N = smp.shape[1], src.shape[1]
    nts, ntp, nts_m, ntp_m = -(-M // T), -(-N // T), -(-M // TM), -(-N // TM)
    S = max(J._steps_for_pairs(min(max_pairs, nts * ntp_m), GM, nts, ntp_m),
            J._steps_for_pairs(min(max_pairs, ntp * nts_m), GM, ntp, nts_m))
    if max_steps is not None:
        S = min(S, max_steps)
    i_ids, j_ids, jb_ids, ib_ids, need = (np.asarray(a) for a in
                                          _jax_lists(smp, qm, src, sm, radius, S))
    return S, i_ids, j_ids, jb_ids, ib_ids, np.maximum(need - S, 0)


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_lists(smp, qm, src, sm, radius, S):
    M, N = smp.shape[1], src.shape[1]
    nts, ntp, nts_m, ntp_m = -(-M // T), -(-N // T), -(-M // TM), -(-N // TM)
    order_s, order_p = J.curve_order(smp, qm), J.curve_order(src, sm)
    sr, _, mn_i, mx_i = J._sorted_tiles(smp, qm, order_s, T, nts * T)
    pr, _, mn_j, mx_j = J._sorted_tiles(src, sm, order_p, T, ntp * T)
    srm, _, mn_im, mx_im = J._sorted_tiles(smp, qm, order_s, TM, nts_m * TM)
    prm, _, mn_jm, mx_jm = J._sorted_tiles(src, sm, order_p, TM, ntp_m * TM)
    adj_f = J._refined_adjacency(sr, mn_i, mx_i, prm, mn_jm, mx_jm, T, radius, TM)
    adj_b = J._refined_adjacency(pr, mn_j, mx_j, srm, mn_im, mx_im, T, radius, TM)
    i_ids, j_ids = J._chunked_pair_lists(adj_f, S, GM, nts - 1, ntp_m)
    jb_ids, ib_ids = J._chunked_pair_lists(adj_b, S, GM, ntp - 1, nts_m)
    return (i_ids, j_ids, jb_ids, ib_ids,
            jnp.maximum(J._needed_steps(adj_f, GM), J._needed_steps(adj_b, GM)))


# ------------------------------------------------------------ host machinery


@pytest.mark.parametrize("bits,seed", [(8, 0), (3, 1)])
def test_hilbert_code_and_order_match_jax(bits, seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 1 << bits, size=(2, 300, 3)).astype(np.int32)
    want = np.asarray(jax.jit(J.hilbert_code, static_argnums=1)(jnp.asarray(c), bits))
    got = P.hilbert_code(torch.from_numpy(c), bits).numpy()
    np.testing.assert_array_equal(got, want)
    if bits == 3:  # the code is a bijection of the cube's cells
        cells = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3)
        codes = P.hilbert_code(torch.from_numpy(cells.astype(np.int32)), 3).numpy()
        assert sorted(codes.tolist()) == list(range(512))
    (jp, jm), (tp, tm) = both(*cloud(seed))
    np.testing.assert_array_equal(P.hilbert_order(tp, tm).numpy(),
                                  np.asarray(jax.jit(J.hilbert_order)(jp, jm)))


@pytest.mark.parametrize("radius", RADII)
def test_sorted_tiles_and_refined_adjacency_match_jax(radius):
    (jp, jm), (tp, tm) = both(*cloud(5, N=500, masked=60))
    _, jv, jmn, jmx = jax.jit(
        lambda p, m: J._sorted_tiles(p, m, J.curve_order(p, m), T, 512))(jp, jm)
    tp_s, tv = P._sorted_rows(tp, tm, P.curve_order(tp, tm), 512)
    tmn, tmx = P._tile_boxes(tp_s, tv, T)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tmn.numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(tmx.numpy(), np.asarray(jmx))
    want = np.asarray(J._count_adjacency(jp, jm, jp, jm, radius, T, TM))
    got = P._count_adjacency(tp, tm, tp, tm, radius, T, TM).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size  # pruning both keeps and drops pairs


@pytest.mark.parametrize("max_pairs,max_steps", [(1 << 30, None), (8, None), (1 << 30, 2)])
def test_step_lists_and_overflow_match_jax(max_pairs, max_steps):
    smp, qm = cloud(4, N=300, masked=25)
    src, sm = cloud(5, N=500, masked=60)
    (js, jq, jsrc, jsm), (ts, tq, tsrc, tsm) = both(smp, qm, src, sm)
    S, i_ids, j_ids, jb_ids, ib_ids, ovf = jax_step_lists(js, jq, jsrc, jsm, RADII[1], max_pairs,
                                                          max_steps)
    lay = P.conv_layout(ts, tq, tsrc, tsm, RADII[1], max_pairs=max_pairs, max_steps=max_steps,
                        backward=True)
    assert lay.S == S
    np.testing.assert_array_equal(lay.overflow.numpy(), ovf)
    # the forward list (sample majors x source minors) and the backward list
    # (source majors x sample minors: JAX's jb_ids / ib_ids)
    for steps, major, minors in ((lay.steps, i_ids, j_ids), (lay.steps_b, jb_ids, ib_ids)):
        np.testing.assert_array_equal(steps.i_ids.numpy(), major)
        np.testing.assert_array_equal(steps.j_ids.numpy(), minors)
        assert (np.diff(major, axis=1) >= 0).all()
        run = steps.run.numpy()
        for b in range(2):  # each tile's run holds exactly the steps of that tile
            for t in range(run.shape[1] - 1):
                assert (major[b, run[b, t]:run[b, t + 1]] == t).all()
    assert lay.steps_b.n_minor == -(-300 // TM)  # the sentinel sample minor
    assert P.conv_layout(ts, tq, tsrc, tsm, RADII[1], max_pairs=max_pairs).steps_b is None
    assert (ovf > 0).all() if max_steps else (ovf == 0).all()


@pytest.mark.parametrize("radius", RADII)
def test_pair_and_step_counts_and_auto_capacity_match_jax(radius):
    # M = N: the forward and backward adjacencies share one compiled JAX
    # program (the step-list and conv tests hold M != N)
    smp, qm = cloud(4, N=500, masked=25)
    src, sm = cloud(5, N=500, masked=60)
    (js, jq, jsrc, jsm), (ts, tq, tsrc, tsm) = both(smp, qm, src, sm)
    for name in ("count_tile_pairs", "count_tile_steps"):
        want = np.asarray(getattr(J, name)(js, jq, jsrc, jsm, radius))
        got = getattr(P, name)(ts, tq, tsrc, tsm, radius).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert P.auto_tile_pairs(tsrc, tsm, radius) == J.auto_tile_pairs(jsrc, jsm, radius)
    want = np.asarray(jsampling.count_poisson_sweep_steps(jsrc, jsm, radius))
    np.testing.assert_array_equal(sampling.count_poisson_sweep_steps(tsrc, tsm, radius).numpy(),
                                  want)


def test_auto_tile_steps_matches_jax():
    # N <= 2048: the JAX hierarchy takes its dense sampler, no interpret kernel
    pts, mask = cloud(5, N=500, masked=60)
    (jp, jm), (tp, tm) = both(pts, mask)
    radii = (RADII[0],)
    cap = P.auto_tile_pairs(tp, tm, 2 * RADII[0])
    want = j_auto_tile_steps(JMCSeg(radii=radii, neighbor_k=500, tile_pairs=cap), jp, jm)
    got = auto_tile_steps(MCSeg(n_classes=4, grow=8, radii=radii, tile_pairs=cap), tp, tm)
    assert got == want
    assert len(got) == 7 and all(v % 16 == 0 and v > 0 for v in got.values())


# ------------------------------------------------------------ K5: tile conv


def conv_case(seed, c_in, c_out, M=180, N=400):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 1, size=(2, N, 3)).astype(np.float32)
    smp = rng.uniform(0, 1, size=(2, M, 3)).astype(np.float32)
    smask = np.ones((2, N), bool)
    smask[0, -50:] = False
    qmask = np.ones((2, M), bool)
    qmask[1, -20:] = False
    feats = rng.normal(size=(2, N, c_in)).astype(np.float32)
    pdf = rng.uniform(0.5, 2.0, size=(2, N)).astype(np.float32)
    out_dim = c_in if c_out is None else c_in * c_out
    params = [rng.normal(size=(3, 8)) * 0.8, rng.normal(size=8) * 0.1,
              rng.normal(size=(8, out_dim)) * 0.5, rng.normal(size=out_dim) * 0.1]
    params = [p.astype(np.float32) for p in params]
    return smp, qmask, src, smask, feats, pdf, params


@pytest.mark.parametrize("c_out,mean", [(None, False), (None, True), (6, False), (6, True)])
def test_tile_conv_plain_matches_jax_lossless(c_out, mean):
    smp, qmask, src, smask, feats, pdf, params = conv_case(9, 5, c_out)
    radius = 0.25

    @jax.jit
    def lossless(prm, q, qm, p, pm, f, d):
        nbh = radius_neighbors(q, qm, p, pm, radius, src.shape[1])
        return mc_conv(JParams(*prm), q, nbh, p, f, d, c_out=c_out, mean_normalize=mean)

    want = lossless(params, smp, qmask, src, smask, feats, pdf)
    want = np.where(qmask[..., None], np.asarray(want), 0.0)
    t = [torch.from_numpy(a) for a in (smp, qmask, src, smask, feats, pdf)]
    got, ovf = P.tile_mc_conv(MCConvParams(*map(torch.from_numpy, params)), *t, radius,
                              max_pairs=1 << 30, c_out=c_out, mean_normalize=mean,
                              with_overflow=True)
    assert (ovf.numpy() == 0).all()
    scale = np.abs(want).max()
    # fp32 sums over the neighbours and channels in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * scale)
    assert (got.numpy()[~qmask] == 0).all()


def test_tile_conv_plain_matches_jax_interpret_with_a_short_budget():
    smp, qmask, src, smask, feats, pdf, params = conv_case(10, 8, None, M=260)
    radius = 0.25
    j = [jnp.asarray(a) for a in (smp, qmask, src, smask, feats, pdf)]
    want, jovf = jax.jit(lambda p, *a: J.tile_mc_conv(
        p, *a, radius, max_pairs=1 << 30, max_steps=2, interpret=True, with_overflow=True,
    ))(JParams(*map(jnp.asarray, params)), *j)
    t = [torch.from_numpy(a) for a in (smp, qmask, src, smask, feats, pdf)]
    got, ovf = P.tile_mc_conv(MCConvParams(*map(torch.from_numpy, params)), *t, radius,
                              max_pairs=1 << 30, max_steps=2, with_overflow=True)
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jovf))
    assert (ovf.numpy() > 0).all()
    want = np.asarray(want)
    # both drop the same steps: the last sample tile gets no neighbour
    assert (np.abs(want).max(-1) == 0).sum() > 0
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)
    # rtol 2e-2: the Pallas kernel holds features and planes in bf16
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


def test_tile_conv_plain_gradients_flow_on_the_cpu():
    smp, qmask, src, smask, feats, pdf, params = conv_case(11, 4, 3, M=100, N=200)
    t = [torch.from_numpy(a) for a in (smp, qmask, src, smask, feats, pdf)]
    prm = [torch.from_numpy(p).requires_grad_() for p in params]
    f = t[4].clone().requires_grad_()
    out = P.tile_mc_conv(MCConvParams(*prm), t[0], t[1], t[2], t[3], f, t[5], 0.3,
                         max_pairs=1 << 30, c_out=3)
    out.square().sum().backward()
    for g in [*(p.grad for p in prm), f.grad]:
        assert g is not None and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


# ------------------------------------------------------------ K7: tile KDE


def test_tile_kde_plain_matches_jax_interpret_and_dense():
    pts, mask = cloud(12, N=400)
    radius = 0.2
    (jp, jm), (tp, tm) = both(pts, mask)
    got, ovf = P.tile_kde(tp, tm, radius, max_pairs=1 << 30, with_overflow=True)
    assert (ovf.numpy() == 0).all()
    want, dense = (np.asarray(x) for x in jax.jit(lambda p, m: (
        J.tile_kde(p, m, radius, max_pairs=1 << 30, interpret=True),
        j_kde_density(p, m, radius)))(jp, jm))
    # rtol 1e-4: the JAX self-pair d2 is not 0 (ROADMAP queue 3), fp32 sums
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-4)
    assert (got.numpy()[~mask] == 1.0).all()


@pytest.mark.parametrize("radius", [0.1, 0.2])
def test_inert_steps_trail_the_last_tiles_run(radius):
    """K7 and K8 stop a tile's run at its first inert step (slot 0 holds the
    sentinel): the real steps are a prefix of the list, the padding after
    them lies in the last tile's run, and ``real_steps`` counts both."""
    pts, mask = cloud(13, N=700)
    lay = P.self_layout(torch.from_numpy(pts), torch.from_numpy(mask), radius,
                        max_pairs=1 << 30, chunk=1)  # 4 minors a step: the budget pads
    st = lay.steps
    real, inert = P.real_steps(st)
    assert torch.equal(real, st.need) and int(inert.min()) > 0
    assert torch.equal(real + inert, torch.full_like(real, lay.S))
    slot0 = st.j_ids[:, 0, :] != st.n_minor
    n_major = st.run.shape[1] - 1
    for b, k in enumerate(real.tolist()):
        assert bool(slot0[b, :k].all()) and not bool(slot0[b, k:].any())
        assert bool((st.i_ids[b, k:] == n_major - 1).all())
        assert int(st.run[b, n_major - 1]) <= k and int(st.run[b, n_major]) == lay.S


# ------------------------------------------------------------ K8 and the tile sampler


def sampler_case(seed, N=500, radius=0.1):
    pts, mask = cloud(seed, N=N, masked=35)
    assert boundary_free(pts, mask, [radius])
    res = grid_res_for_radius(radius, cell_scale=1.0 / jsampling._SQRT3)
    return pts, mask, res


SWEEP_RADIUS = 0.1


@pytest.fixture(scope="module")
def sweep_case():
    """One cloud through the JAX tile sampler and one cover query with random
    flags, both in interpret mode, in one compiled JAX program."""
    pts, mask, res = sampler_case(15, radius=SWEEP_RADIUS)
    (jp, jm), (tp, tm) = both(pts, mask)
    sweep = P.make_cover_sweep(tp, tm, SWEEP_RADIUS, max_pairs=1 << 30)
    valid = sweep.valid.numpy()
    flags = valid & (np.random.default_rng(14).uniform(size=valid.shape) < 0.3)

    @jax.jit
    def jax_refs(p, m, f):
        r = SWEEP_RADIUS
        jsweep = J.make_cover_sweep(p, m, r, max_pairs=1 << 30, interpret=True)
        jshort = J.make_cover_sweep(p, m, r, max_pairs=1 << 30, max_steps=2)
        jc = cell_coords(p, r / jsampling._SQRT3, res)
        tiles = jsampling._poisson_tiles(p, m, jc, linear_cell_ids(jc, res), cell_color27(jc),
                                         r, res, 1 << 30, True)
        return jsweep.valid, jsweep.counts(f), jshort.overflow, *tiles

    jvalid, counts, short_ovf, tiles, tiles_ovf = (
        np.asarray(a) for a in jax_refs(jp, jm, jnp.asarray(flags, jnp.float32)))
    return dict(pts=pts, mask=mask, res=res, tp=tp, tm=tm, sweep=sweep, flags=flags,
                jvalid=jvalid, counts=counts, short_ovf=short_ovf, tiles=tiles,
                tiles_ovf=tiles_ovf)


def test_cover_counts_plain_equal_jax_interpret(sweep_case):
    c = sweep_case
    valid = c["sweep"].valid.numpy()
    np.testing.assert_array_equal(valid, c["jvalid"])
    got = c["sweep"].counts(torch.from_numpy(c["flags"])).numpy()
    want = c["counts"]
    np.testing.assert_array_equal(got[valid], want[valid].astype(np.int32))
    assert got[valid].max() > 1 and (got[~valid] == 0).all()
    short = P.make_cover_sweep(c["tp"], c["tm"], SWEEP_RADIUS, max_pairs=1 << 30, max_steps=2)
    np.testing.assert_array_equal(short.overflow.numpy(), c["short_ovf"])
    assert (c["short_ovf"] > 0).all()


def test_tile_sampler_equals_jax_interpret_and_the_dense_sweep(sweep_case):
    c = sweep_case
    tp, tm, mask = c["tp"], c["tm"], c["mask"]
    tc, _ = sampling._sampler_grid(tp, SWEEP_RADIUS)
    cids, colors = sampling.sweep_cells(tp, SWEEP_RADIUS)
    got, ovf = sampling._poisson_tiles(tp, tm, tc, cids, colors, SWEEP_RADIUS, c["res"], 1 << 30)
    np.testing.assert_array_equal(got.numpy(), c["tiles"])
    assert (ovf.numpy() == 0).all() and (c["tiles_ovf"] == 0).all()
    dense = poisson_sweep_reference(tp, tm, cids, colors, SWEEP_RADIUS)
    np.testing.assert_array_equal(got.numpy(), dense.numpy())
    assert 10 < got.sum() < mask.sum() and not (got.numpy() & ~mask).any()
