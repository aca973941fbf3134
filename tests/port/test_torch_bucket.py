"""The bucket path of mccnn_tpu_torch against the JAX package, on the CPU:
the cell-bucket layout, the neighbour lists, the neighbour-list sampler and
the plain versions of K9 and K10 (the cell-bucket MC conv and its backward).

``build_buckets`` must equal the reference's exactly, field by field, at a
cap that overflows and at one that does not. The neighbour lists and the
sampler are compared as sets and selections on inputs with no pair at the
radius (the two packages round d2 differently). On CPU tensors
``bucket_mc_conv`` runs ``BucketMCConvFunction`` with the plain K9 forward
and the plain K10 backward; they are held against the lossless
neighbour-list ``mc_conv`` (``k = N``, fp32, tight) and its ``jax.grad``, and
against the reference's bucket kernel in interpret mode, which runs its
features in bf16 (``mcconv_kernel.py:55``) and shares the cell-overflow
drops. The CUDA kernels are held against the same plain versions on the card
(``test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.core import buckets as JB
from mccnn_tpu.core import mc_conv, radius_neighbors
from mccnn_tpu.core import sampling as JS
from mccnn_tpu.core.mcconv import MCConvParams as JParams
from mccnn_tpu.core.neighbors import self_neighbors as j_self_neighbors
from mccnn_tpu.ops.pallas import bucket_mc_conv as j_bucket_mc_conv
from mccnn_tpu_torch.core import buckets as PB
from mccnn_tpu_torch.core import neighbors as PN
from mccnn_tpu_torch.core import sampling as PS
from mccnn_tpu_torch.core.mcconv import MCConvParams
from mccnn_tpu_torch.ops.cuda import mcconv_kernel as PK

RADIUS = 0.25  # R = 4 cells a side
SEED = 3  # boundary_free at RADIUS
CAP_S, CAP_P, CAP_SMALL = 32, 32, 8  # CAP_SMALL overflows source cells
CASES = {  # c_out, mean_normalize
    "depthwise": (None, False),
    "full": (4, False),
    "depthwise_mean": (None, True),
    "full_mean": (4, True),
}
NAMES = ("dw1", "db1", "dw2", "db2", "dfeatures")


def conv_case(seed, c_in, c_out, M=120, N=300):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 1, size=(2, N, 3)).astype(np.float32)
    smp = rng.uniform(0, 1, size=(2, M, 3)).astype(np.float32)
    smask = np.ones((2, N), bool)
    smask[0, -40:] = False
    qmask = np.ones((2, M), bool)
    qmask[1, -15:] = False
    feats = rng.normal(size=(2, N, c_in)).astype(np.float32)
    pdf = rng.uniform(0.5, 2.0, size=(2, N)).astype(np.float32)
    out_dim = c_in if c_out is None else c_in * c_out
    params = [rng.normal(size=(3, 8)) * 0.8, rng.normal(size=8) * 0.1,
              rng.normal(size=(8, out_dim)) * 0.5, rng.normal(size=out_dim) * 0.1]
    cot = rng.normal(size=(2, M, c_in if c_out is None else c_out))
    return dict(smp=smp, qmask=qmask, src=src, smask=smask, feats=feats, pdf=pdf,
                params=[p.astype(np.float32) for p in params], cot=cot.astype(np.float32))


def boundary_free(q, qm, p, pm, radius, tol=1e-6):
    """No valid pair with |d^2 - r^2| < tol (float64), and no coordinate
    within tol of a cell face of the layout (edge = radius)."""
    d = q[:, :, None].astype(np.float64) - p[:, None].astype(np.float64)
    near = np.abs((d**2).sum(-1) - radius**2) < tol
    x = np.concatenate([q.reshape(-1), p.reshape(-1)]) / radius
    return not (near & qm[:, :, None] & pm[:, None]).any() and np.abs(x - np.round(x)).min() > tol


def port_layouts(case, cap_p=CAP_P):
    t = {k: torch.from_numpy(v) for k, v in case.items() if isinstance(v, np.ndarray)}
    return (PB.build_buckets(t["smp"], t["qmask"], RADIUS, CAP_S),
            PB.build_buckets(t["src"], t["smask"], RADIUS, cap_p), t)


def port_grads(case, c_out, mean, cap_p=CAP_P):
    """Output and gradients of sum(out * cot) through ``bucket_mc_conv``."""
    gs, gp, t = port_layouts(case, cap_p)
    params = [torch.from_numpy(p).requires_grad_() for p in case["params"]]
    feats = t["feats"].requires_grad_()
    out = PK.bucket_mc_conv(MCConvParams(*params), gs, t["qmask"], gp, feats, t["pdf"],
                            c_out=c_out, mean_normalize=mean)
    (out * t["cot"]).sum().backward()
    return out.detach().numpy(), [p.grad.numpy() for p in params] + [feats.grad.numpy()]


def jax_out_and_grads(case, conv):
    """``conv(params, feats)`` masked, and the gradients of sum(out * cot):
    its VJP at cot, one trace of the forward (traced: call it inside
    ``jax.jit``)."""

    def out_fn(params, feats):
        return jnp.where(case["qmask"][..., None], conv(JParams(*params), feats), 0.0)

    out, vjp = jax.vjp(out_fn, case["params"], case["feats"])
    gp, gf = vjp(jnp.asarray(case["cot"], out.dtype))
    return out, [*gp, gf]


def assert_close_to_scale(got, want, rel, names=NAMES):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=rel, atol=rel * scale, err_msg=name)


# ------------------------------------------------------------ the layout


@pytest.fixture(scope="module")
def layouts():
    case = conv_case(SEED, 1, None)

    @jax.jit
    def both(src, smask):
        return [JB.build_buckets(src, smask, RADIUS, cap) for cap in (CAP_SMALL, CAP_P)]

    return case, both(case["src"], case["smask"])


@pytest.mark.parametrize("cap", [CAP_SMALL, CAP_P])
def test_build_buckets_matches_jax(layouts, cap):
    case, grids = layouts
    want = grids[(CAP_SMALL, CAP_P).index(cap)]
    got = PB.build_buckets(torch.from_numpy(case["src"]), torch.from_numpy(case["smask"]),
                           RADIUS, cap)
    assert (got.res, got.cap, got.radius) == (want.res, want.cap, want.radius) == (4, cap, RADIUS)
    assert got.n_slots == want.n_slots
    np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(want.overflow))
    assert (got.overflow.numpy() > 0).all() == (cap == CAP_SMALL)
    np.testing.assert_array_equal(got.slot_of_point.numpy(), np.asarray(want.slot_of_point))
    np.testing.assert_array_equal(got.slot_mask.numpy(), np.asarray(want.slot_mask))
    assert not got.slot_mask[:, -1].any()  # the trash slot holds no point
    # point_of_slot: equal on every slot but the trash slot, where every
    # dropped point lands and the value is undefined in both packages (0 here)
    np.testing.assert_array_equal(got.point_of_slot.numpy()[:, :-1],
                                  np.asarray(want.point_of_slot)[:, :-1])
    assert (got.point_of_slot[:, -1] == 0).all()
    # positions: equal on kept slots; the reference parks the others at
    # SENTINEL for its kernels' distance test, the port keeps 0 there
    m = got.slot_mask.numpy()
    np.testing.assert_array_equal(got.positions.numpy(),
                                  np.where(m[..., None], np.asarray(want.positions), 0.0))
    assert (np.asarray(want.positions)[~m] == JB.SENTINEL).all()
    # the port's per-cell counts: the kept points fill each cell's first slots
    Rp = got.padded_res
    np.testing.assert_array_equal(got.cell_count.numpy(), m[:, :-1].reshape(2, Rp**3, cap).sum(-1))
    first = np.arange(cap) < got.cell_count.numpy()[..., None]
    np.testing.assert_array_equal(first, m[:, :-1].reshape(2, Rp**3, cap))


def test_bucketize_unbucketize_and_default_cap_match_jax(layouts):
    # the port has no bucketize / unbucketize (its kernels read and write in
    # point order): the reference's views, formed here from the port's
    # point_of_slot / slot_mask / slot_of_point, must equal the JAX ones
    case, grids = layouts
    want_grid = grids[0]
    got_grid = PB.build_buckets(torch.from_numpy(case["src"]), torch.from_numpy(case["smask"]),
                                RADIUS, CAP_SMALL)
    vals = case["feats"] * 3.0 + 1.0
    want = np.asarray(JB.bucketize(want_grid, jnp.asarray(vals), fill=-2.0))
    pos, keep = got_grid.point_of_slot.numpy(), got_grid.slot_mask.numpy()
    got = np.where(keep[..., None], np.take_along_axis(vals, pos[..., None], 1), -2.0)
    np.testing.assert_array_equal(got[:, :-1], want[:, :-1])
    back = np.take_along_axis(got, got_grid.slot_of_point.numpy()[..., None], 1)
    back = np.where(case["smask"][..., None], back, 0.0)
    want_back = JB.unbucketize(want_grid, jnp.asarray(want), jnp.asarray(case["smask"]))
    np.testing.assert_array_equal(back, np.asarray(want_back))
    for n, r in [(8192, 0.05), (1944, 0.1), (224, 0.3), (4096, 0.2), (300, 0.25)]:
        assert PB.default_cap(n, r) == JB.default_cap(n, r)
        assert PB.res_for_radius(r) == JB.res_for_radius(r)


# ------------------------------------------------------------ neighbour lists, sampler

NBH_RADIUS = 0.15


@pytest.fixture(scope="module")
def neighbour_case():
    rng = np.random.default_rng(8)
    pts = rng.uniform(0, 1, size=(2, 400, 3)).astype(np.float32)
    mask = np.ones((2, 400), bool)
    mask[1, -30:] = False
    assert boundary_free(pts, mask, pts, mask, NBH_RADIUS)
    full = int(400)

    @jax.jit
    def lists(p, m):
        return [j_self_neighbors(p, m, NBH_RADIUS, k) for k in (full, 6)]

    return pts, mask, lists(pts, mask)


def sets(nbh_idx, nbh_mask):
    return [[frozenset(i[m].tolist()) for i, m in zip(ib, mb)]
            for ib, mb in zip(np.asarray(nbh_idx), np.asarray(nbh_mask))]


@pytest.mark.parametrize("k", [400, 6])
def test_neighbor_lists_match_jax(neighbour_case, k):
    pts, mask, lists = neighbour_case
    want = lists[0 if k == 400 else 1]
    got = PN.self_neighbors(torch.from_numpy(pts), torch.from_numpy(mask), NBH_RADIUS, k)
    assert got.idx.shape == (2, 400, k) and got.radius == want.radius
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert int(got.count.max()) > 6  # k = 6 truncates
    g, w = sets(got.idx.numpy(), got.mask.numpy()), sets(want.idx, want.mask)
    if k == 400:
        assert g == w
        return
    # truncated lists keep the k nearest: equal sets unless the k-th and the
    # (k+1)-th distances are too close to order alike in both packages
    p = pts.astype(np.float64)
    d2 = ((p[:, :, None] - p[:, None]) ** 2).sum(-1)
    d2 = np.where(mask[:, None] & mask[:, :, None] & (d2 <= NBH_RADIUS**2), d2, np.inf)
    srt = np.sort(d2, axis=-1)
    with np.errstate(invalid="ignore"):  # inf - inf past the last neighbour
        clear = (srt[..., k] - srt[..., k - 1] > 1e-6) | ~np.isfinite(srt[..., k])
    assert clear.mean() > 0.95
    for b in range(2):
        for i in np.flatnonzero(clear[b]):
            assert g[b][i] == w[b][i], (b, i)
    # the radius_neighbors entry point between two sets, chunked
    q = torch.from_numpy(pts[:, :100].copy())
    got2 = PN.radius_neighbors(q, torch.from_numpy(mask[:, :100].copy()), torch.from_numpy(pts),
                               torch.from_numpy(mask), NBH_RADIUS, 400, query_chunk=7)
    want2 = radius_neighbors(pts[:, :100], mask[:, :100], pts, mask, NBH_RADIUS, 400)
    np.testing.assert_array_equal(got2.count.numpy(), np.asarray(want2.count))
    assert sets(got2.idx.numpy(), got2.mask.numpy()) == sets(want2.idx, want2.mask)


@pytest.mark.parametrize("k", [400, 6])
def test_poisson_neighbor_lists_match_jax(neighbour_case, k):
    # the same neighbourhood (JAX's) on both sides: the sweep itself, at a
    # capacity above every count and one that truncates coverage
    pts, mask, lists = neighbour_case
    want_nbh = lists[0 if k == 400 else 1]
    cids, colors = PS.sweep_cells(torch.from_numpy(pts), NBH_RADIUS)
    res = PS.grid_res_for_radius(NBH_RADIUS, cell_scale=1.0 / PS._SQRT3)
    want = JS._poisson_neighbor_lists(jnp.asarray(cids.numpy()), jnp.asarray(colors.numpy()),
                                      jnp.asarray(mask), want_nbh, res**3, 400)
    nbh = PN.Neighborhood(*(torch.from_numpy(np.array(x)) for x in
                            (want_nbh.idx, want_nbh.mask, want_nbh.count)), NBH_RADIUS)
    got = PS._poisson_neighbor_lists(cids, colors, torch.from_numpy(mask), nbh, res**3, 400)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < int(mask.sum())


def test_poisson_disk_takes_neighbor_lists_above_the_dense_bound():
    # N > 4096 without a tile capacity: the port builds the self-neighbourhood
    # (k = 48, the reference's default) and the selection is the dense
    # sampler's when no list is truncated
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.uniform(0, 1, size=(1, 4104, 3)).astype(np.float32))
    mask = torch.ones((1, 4104), dtype=torch.bool)
    got = PS.poisson_disk(pts, mask, 0.1, 600)
    nbh = PN.self_neighbors(pts, mask, 0.1, 48)
    assert int(nbh.count.max()) <= 48
    cids, colors = PS.sweep_cells(pts, 0.1)
    dense = PS.poisson_sweep(pts, mask, cids, colors, 0.1)
    np.testing.assert_array_equal(got.selected.numpy(), dense.numpy())
    assert got.overflow is None and 0 < int(got.mask.sum()) < 600


# ------------------------------------------------------------ K9 / K10 plain versions


@pytest.fixture(scope="module")
def lossless():
    """Each case's inputs, the JAX lossless outputs and gradients, one compiled program."""
    cases = {name: conv_case(SEED, 5, c_out) for name, (c_out, _) in CASES.items()}
    for c in cases.values():
        assert boundary_free(c["smp"], c["qmask"], c["src"], c["smask"], RADIUS)

    @jax.jit
    def all_cases(cases):
        out = {}
        for name, (c_out, mean) in CASES.items():
            c = cases[name]
            # k = N makes the neighbour-list conv lossless (tests/test_pallas_mcconv.py:34-38)
            nbh = radius_neighbors(c["smp"], c["qmask"], c["src"], c["smask"], RADIUS,
                                   c["src"].shape[1])
            out[name] = jax_out_and_grads(c, lambda prm, f, c=c, nbh=nbh, c_out=c_out, mean=mean:
                                          mc_conv(prm, c["smp"], nbh, c["src"], f, c["pdf"],
                                                  c_out=c_out, mean_normalize=mean))
        return out

    return cases, all_cases(cases)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_backward_match_jax_lossless(lossless, name):
    cases, want = lossless
    c_out, mean = CASES[name]
    out, grads = port_grads(cases[name], c_out, mean)
    gs, gp, _ = port_layouts(cases[name])
    assert int(gs.overflow.max()) == int(gp.overflow.max()) == 0
    # both sides fp32 over the same pairs, sums in other orders: the output
    # 1e-5 of its largest value, each gradient 1e-4 of its largest value
    assert_close_to_scale([out], [want[name][0]], 1e-5, names=["out"])
    assert_close_to_scale(grads, want[name][1], 1e-4)


INTERPRET = {  # c_out, mean_normalize, source cap (lossless cases cover the rest)
    "full_mean_overflow": (4, True, CAP_SMALL),
}


@pytest.fixture(scope="module")
def interpret():
    """The reference's bucket kernel in interpret mode: the outputs and
    gradients of each INTERPRET case, one compiled program."""
    cases = {name: conv_case(SEED + 1, 6, c_out, M=100, N=260)
             for name, (c_out, _, _) in INTERPRET.items()}
    for c in cases.values():
        assert boundary_free(c["smp"], c["qmask"], c["src"], c["smask"], RADIUS)

    @jax.jit
    def all_cases(cases):
        out = {}
        for name, (c_out, mean, cap_p) in INTERPRET.items():
            c = cases[name]
            sg = JB.build_buckets(c["smp"], c["qmask"], RADIUS, CAP_S)
            gg = JB.build_buckets(c["src"], c["smask"], RADIUS, cap_p)
            out[name] = jax_out_and_grads(c, lambda prm, f, c=c, sg=sg, gg=gg, c_out=c_out,
                                          mean=mean: j_bucket_mc_conv(
                                              prm, sg, c["qmask"], gg, f, c["pdf"], c_out=c_out,
                                              mean_normalize=mean, interpret=True))
            out[name + "/overflow"] = gg.overflow
        return out

    return cases, all_cases(cases)


@pytest.mark.parametrize("name", list(INTERPRET))
def test_forward_and_backward_match_jax_interpret_kernel(interpret, name):
    cases, want = interpret
    c_out, mean, cap_p = INTERPRET[name]
    out, grads = port_grads(cases[name], c_out, mean, cap_p)
    _, gp, _ = port_layouts(cases[name], cap_p)
    np.testing.assert_array_equal(gp.overflow.numpy(), np.asarray(want[name + "/overflow"]))
    assert (gp.overflow.numpy() > 0).all() == (cap_p == CAP_SMALL)
    # the reference's kernel runs features (and its backward's planes and
    # cotangent) in bf16: the output 2e-2 of its largest value
    # (tests/test_pallas_mcconv.py:60), each gradient 3e-2 of its largest value
    assert_close_to_scale([out], [want[name][0]], 2e-2, names=["out"])
    assert_close_to_scale(grads, want[name][1], 3e-2)


def test_overflow_drops_points_from_every_sum():
    # a dropped sample gets 0; a dropped source is in no sum and gets no gradient
    case = conv_case(SEED + 2, 3, None)
    out, grads = port_grads(case, None, False, CAP_SMALL)
    gs, gp, t = port_layouts(case, CAP_SMALL)
    assert int(gp.overflow.min()) > 0
    dropped = (~PK.kept_points(gp) & t["smask"]).numpy()
    assert dropped.any() and (grads[-1][dropped] == 0).all()
    assert np.abs(grads[-1][PK.kept_points(gp).numpy()]).max() > 0
    # the same conv with the dropped sources' features changed is unchanged
    feats = case["feats"].copy()
    feats[dropped] = 1e3
    out2, _ = port_grads({**case, "feats": feats}, None, False, CAP_SMALL)
    np.testing.assert_array_equal(out, out2)
    # the sources as samples, in a layout that overflows: the dropped ones get 0
    params = MCConvParams(*(torch.from_numpy(p) for p in case["params"]))
    res = PK.bucket_mc_conv(params, gp, t["smask"], gp, t["feats"], t["pdf"])
    lost = dropped
    assert lost.any() and (res.numpy()[lost] == 0).all()


@pytest.mark.parametrize("c_out,mean", [(3, False), (None, True)])
def test_explicit_backward_matches_autograd_of_the_plain_forward(c_out, mean):
    case = conv_case(SEED + 4, 2, c_out, M=50, N=120)
    gs, gp, t = port_layouts(case, CAP_SMALL)
    g = torch.Generator().manual_seed(1)
    inputs = [torch.from_numpy(p).double().requires_grad_() for p in case["params"]]
    wf = torch.where(PK.kept_points(gp)[..., None], t["feats"] / t["pdf"][..., None], 0.0)
    inputs.append(wf.double().requires_grad_())
    gs, gp = (grid._replace(positions=grid.positions.double()) for grid in (gs, gp))

    def f(w1, b1, w2, b2, wf):
        return PK.BucketMCConvFunction.apply(w1, b1, w2, b2, wf, gs, gp, c_out, mean)

    assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-6, rtol=1e-5, fast_mode=True)
    # and against autograd through the plain forward, in fp32
    p32 = [x.detach().float().requires_grad_() for x in inputs]
    gs32, gp32 = (grid._replace(positions=grid.positions.float()) for grid in (gs, gp))
    out, _ = PK.bucket_conv_reference(MCConvParams(*p32[:4]), gs32, gp32, p32[4], c_out=c_out,
                                      mean_normalize=mean)
    dout = torch.randn(out.shape, generator=g)
    want = torch.autograd.grad((out * dout).sum(), p32)
    _, cnt = PK.bucket_conv_reference(MCConvParams(*p32[:4]), gs32, gp32, p32[4], c_out=c_out,
                                      mean_normalize=mean)
    got = PK.bucket_conv_backward_reference(MCConvParams(*(x.detach() for x in p32[:4])), gs32,
                                            gp32, p32[4].detach(), cnt, dout, c_out=c_out,
                                            mean_normalize=mean)
    got = [got[1], got[2], got[3], got[4], got[0]]
    assert_close_to_scale([x.numpy() for x in got], [w.numpy() for w in want], 1e-5)


def test_positions_get_no_gradient_and_masked_samples_are_zero():
    case = conv_case(SEED + 5, 2, 4, M=60, N=150)
    gs, gp, t = port_layouts(case)
    params = MCConvParams(*(torch.from_numpy(p).requires_grad_() for p in case["params"]))
    pos = gp.positions.clone().requires_grad_()
    out = PK.bucket_mc_conv(params, gs, t["qmask"], gp._replace(positions=pos), t["feats"],
                            t["pdf"], c_out=4)
    assert (out[~t["qmask"]] == 0).all() and float(out.abs().max()) > 0
    out.sum().backward()
    assert pos.grad is None and all(p.grad is not None for p in params)
