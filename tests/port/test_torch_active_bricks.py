"""The bucket conv over active bricks (K9a / K10a, ``max_active_bricks``)
against the JAX package, on the CPU.

The brick host code (``pick_bz``, the brick order of the reference's
block-major layout and its inverse, ``count_active_bricks``,
``_brick_activity``) must equal the reference's exactly on seeded layouts at
several (R, cap). ``bucket_mc_conv(..., max_active_bricks=)`` runs the plain
K9a / K10a on CPU tensors; it is held against the reference's kernel in
interpret mode (features in bf16: the output within 2e-2 of its largest
value, each gradient within 3e-2) on a case whose layout holds 8 occupied
bricks of 27 in each cloud (r = 0.2 gives R = 6, cap 16 gives BZ = 2): at
NBA = 8, which visits every occupied brick, and at NBA = 6, which drops two.
The reference's own test of the switch (``tests/test_pallas_mcconv.py:127``)
asks for more bricks than its grid has and so compares the dense sweep with
itself. Interpret-mode programs are costly (about 10 s each to trace and
compile), so the JAX side is one jitted program of two cases: the lossless
NBA depthwise and the lossy NBA with ``c_out`` and the mean. The card holds
the kernels against the plain versions (``test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import numpy as np
import pytest
import torch

import test_torch_bucket as bt
from mccnn_tpu.core import buckets as JB
from mccnn_tpu.ops.pallas import bucket_mc_conv as j_bucket_mc_conv
from mccnn_tpu.ops.pallas import mcconv_kernel as JK
from mccnn_tpu_torch.core import buckets as PB
from mccnn_tpu_torch.core.mcconv import MCConvParams
from mccnn_tpu_torch.ops.cuda import mcconv_kernel as PK

RADIUS, CAP = 0.2, 16  # R = 6, BZ = 2: 27 bricks
N_BRICKS = 27
OCCUPIED = 8  # of each cloud's bricks: the points lie in [0, 0.5)^3
CONV_CASES = {  # max_active_bricks, c_out, mean_normalize
    "lossless_depthwise": (OCCUPIED, None, False),
    "lossy_full_mean": (6, 4, True),
}
LAYOUTS = [(0.2, 16), (0.2, 8), (0.1, 24), (0.05, 8)]  # (radius, cap) of the host-code checks
HOST_NBA = 5


def conv_case(seed=0, B=2, N=128, C=8, c_out=None):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 0.5, size=(B, N, 3)).astype(np.float32)
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    pdf = rng.uniform(0.5, 2.0, size=(B, N)).astype(np.float32)
    out_dim = C if c_out is None else C * c_out
    params = [rng.normal(size=(3, 8)) * 0.8, rng.normal(size=8) * 0.1,
              rng.normal(size=(8, out_dim)) * 0.5, rng.normal(size=out_dim) * 0.1]
    cot = rng.normal(size=(B, N, C if c_out is None else c_out))
    return dict(pts=pts, mask=np.ones((B, N), bool), feats=feats, pdf=pdf,
                params=[p.astype(np.float32) for p in params], cot=cot.astype(np.float32))


def host_points(seed=1, B=2, N=300):
    """Two clouds of other extents (so other occupied counts), a masked tail."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, size=(B, N, 3)).astype(np.float32)
    pts[0] *= 0.45
    mask = np.ones((B, N), bool)
    mask[1, -40:] = False
    return pts, mask


def port_grid(pts, mask, radius=RADIUS, cap=CAP):
    return PB.build_buckets(torch.from_numpy(pts), torch.from_numpy(mask), radius, cap)


def port_grads(case, c_out, mean, nba):
    """Output and gradients of sum(out * cot) through ``bucket_mc_conv``,
    one layout as the sample and the source grid."""
    t = {k: torch.from_numpy(v) for k, v in case.items() if isinstance(v, np.ndarray)}
    grid = port_grid(case["pts"], case["mask"])
    params = [torch.from_numpy(p).requires_grad_() for p in case["params"]]
    feats = t["feats"].requires_grad_()
    out = PK.bucket_mc_conv(MCConvParams(*params), grid, t["mask"], grid, feats, t["pdf"],
                            c_out=c_out, mean_normalize=mean, max_active_bricks=nba)
    (out * t["cot"]).sum().backward()
    return out.detach().numpy(), [p.grad.numpy() for p in params] + [feats.grad.numpy()]


@pytest.fixture(scope="module")
def reference():
    """One program: the reference's interpret-mode conv and gradients of each
    CONV_CASES case, and its brick host code on the LAYOUTS layouts."""
    cases = {name: conv_case(c_out=c_out) for name, (_, c_out, _) in CONV_CASES.items()}
    for c in cases.values():
        assert bt.boundary_free(c["pts"], c["mask"], c["pts"], c["mask"], RADIUS)
    pts, mask = host_points()

    @jax.jit
    def program(cases, pts, mask):
        out = {}
        for name, (nba, c_out, mean) in CONV_CASES.items():
            c = cases[name]
            g = JB.build_buckets(c["pts"], c["mask"], RADIUS, CAP)
            out[name] = bt.jax_out_and_grads(
                {**c, "qmask": c["mask"]},
                lambda prm, f, c=c, g=g, c_out=c_out, mean=mean, nba=nba: j_bucket_mc_conv(
                    prm, g, c["mask"], g, f, c["pdf"], c_out=c_out, mean_normalize=mean,
                    interpret=True, max_active_bricks=nba))
        for radius, cap in LAYOUTS:
            g = JB.build_buckets(pts, mask, radius, cap)
            bz = JK.pick_bz(g.res, cap)
            out[f"{radius}/{cap}"] = (JK.count_active_bricks(g),
                                      *JK._brick_activity(g, cap, g.res, bz, HOST_NBA))
        return out

    return cases, program(cases, pts, mask)


# ------------------------------------------------------------ the brick host code


def test_pick_bz_matches_jax():
    for R in (2, 4, 6, 10, 20, 32, 64):
        for cap in (8, 16, 24, 32, 40, 64, 96, 136):
            assert PK.pick_bz(R, cap) == JK.pick_bz(R, cap), (R, cap)
    assert PK.pick_bz(20, 32) == 1 and PK.pick_bz(6, 16) == 2 and PK.pick_bz(2, 8) == 2


@pytest.mark.parametrize("layout", LAYOUTS)
def test_brick_order_and_activity_match_jax(reference, layout):
    radius, cap = layout
    pts, mask = host_points()
    want_count, want_ids, want_ranks = reference[1][f"{radius}/{cap}"]
    grid = port_grid(pts, mask, radius, cap)
    R = grid.res
    bz = PK.pick_bz(R, cap)
    # the reference's block-major layout: row k of brick_cells, times cap, plus the slot
    perm = np.asarray(JK._block_perm(R, cap, bz))
    cells = PK.brick_cells(R, bz).numpy()
    np.testing.assert_array_equal((cells[..., None] * cap + np.arange(cap)).reshape(-1), perm)
    # its inverse: the block-major row's brick (one past the last for ghost cells)
    inv = np.asarray(JK._inv_block_perm(R, cap, bz))
    rows = np.arange(inv.shape[0])
    np.testing.assert_array_equal(PK.cell_brick(R, bz).numpy()[rows // cap],
                                  inv // (4 * bz * cap))
    assert PK.n_bricks(R, bz) == len(perm) // (4 * bz * cap)
    np.testing.assert_array_equal(PK.count_active_bricks(grid).numpy(), np.asarray(want_count))
    bricks = PK._brick_activity(grid, bz, HOST_NBA)
    assert bricks.ids.dtype == bricks.ranks.dtype == torch.int32
    np.testing.assert_array_equal(bricks.ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(bricks.ranks.numpy(), np.asarray(want_ranks))
    counts = PK.count_active_bricks(grid).tolist()
    assert counts[0] != counts[1]  # the clouds occupy different numbers of bricks


# ------------------------------------------------------------ K9a / K10a plain versions


@pytest.mark.parametrize("name", list(CONV_CASES))
def test_active_brick_conv_matches_jax_interpret_kernel(reference, name):
    cases, want = reference
    nba, c_out, mean = CONV_CASES[name]
    case = cases[name]
    grid = port_grid(case["pts"], case["mask"])
    assert PK.count_active_bricks(grid).tolist() == [OCCUPIED, OCCUPIED]
    out, grads = port_grads(case, c_out, mean, nba)
    want_out, want_grads = (np.asarray(x) if not isinstance(x, list) else x
                            for x in want[name])
    bt.assert_close_to_scale([out], [want_out], 2e-2, names=["out"])
    bt.assert_close_to_scale(grads, want_grads, 3e-2)
    # where the reference drops, both hold exact zeros: the samples of
    # unvisited sample bricks and the feature gradients of the sources of
    # unvisited source bricks (one layout: the same bricks)
    active = PK.active_bricks(grid, grid, nba)
    dropped = (~PK.visited_points(grid, active.smp, active.bz)).numpy()
    assert dropped.sum() == (16 if nba < OCCUPIED else 0)
    assert (out[dropped] == 0).all() and (want_out[dropped] == 0).all()
    assert (grads[-1][dropped] == 0).all() and (np.asarray(want_grads[-1])[dropped] == 0).all()
    assert np.abs(out[~dropped]).max() > 0


@pytest.mark.parametrize("name", list(bt.CASES))
def test_lossless_nba_is_the_dense_sweep_bit_for_bit(name):
    c_out, mean = bt.CASES[name]
    case = conv_case(seed=2, c_out=c_out)
    out, grads = port_grads(case, c_out, mean, OCCUPIED)
    dense_out, dense_grads = port_grads(case, c_out, mean, None)
    np.testing.assert_array_equal(out, dense_out)
    for g, d in zip(grads, dense_grads):
        np.testing.assert_array_equal(g, d)


def test_nba_routes_as_the_reference(monkeypatch):
    # mcconv_kernel.py:872-878: min(NBA, bricks), and the dense sweep from the
    # brick count on; the plain versions stand for the kernels on the CPU
    calls = []
    for fn in ("bucket_conv_reference", "bucket_conv_active_reference",
               "bucket_conv_backward_reference", "bucket_conv_backward_active_reference"):
        real = getattr(PK, fn)

        def spy(*args, _real=real, _fn=fn, **kw):
            active = [a for a in args if isinstance(a, PK.ActiveBricks)]
            calls.append((_fn, tuple(active[0].smp.ids.shape) if active else None))
            return _real(*args, **kw)

        monkeypatch.setattr(PK, fn, spy)
    case = conv_case(seed=3)
    for nba, route in [(N_BRICKS, "dense"), (1000, "dense"), (None, "dense"),
                       (N_BRICKS - 1, "active"), (1, "active")]:
        calls.clear()
        port_grads(case, None, False, nba)
        names = [fn for fn, _ in calls]
        if route == "dense":
            assert names == ["bucket_conv_reference", "bucket_conv_backward_reference"], nba
        else:
            assert names[0] == "bucket_conv_active_reference", nba
            assert "bucket_conv_backward_active_reference" in names, nba
            assert calls[0][1] == (2, nba)
    with pytest.raises(ValueError, match="at least 1"):
        port_grads(case, None, False, 0)


def test_lossy_backward_is_the_references_not_the_gradient_of_its_forward(reference):
    # Under a lossy NBA the forward reads every source of a visited sample's
    # window, but the backward walks only the visited source bricks: the
    # sources of the others get 0 and their pairs are missing from dW. The
    # port copies the reference (ROADMAP queue 3).
    cases, want = reference
    name = "lossy_full_mean"
    nba, c_out, mean = CONV_CASES[name]
    case = cases[name]
    _, grads = port_grads(case, c_out, mean, nba)
    want_grads = [np.asarray(g) for g in want[name][1]]
    # autograd through the plain lossy forward: its true gradient
    grid = port_grid(case["pts"], case["mask"])
    active = PK.active_bricks(grid, grid, nba)
    params = [torch.from_numpy(p).double().requires_grad_() for p in case["params"]]
    feats = torch.from_numpy(case["feats"]).double().requires_grad_()
    g64 = grid._replace(positions=grid.positions.double())
    wf = torch.where(PK.kept_points(grid)[..., None],
                     feats / torch.from_numpy(case["pdf"]).double()[..., None], 0.0)
    out, _ = PK.bucket_conv_active_reference(MCConvParams(*params), g64, g64, wf, active,
                                             c_out=c_out, mean_normalize=mean)
    (out * torch.from_numpy(case["cot"]).double()).sum().backward()
    true = [p.grad.numpy() for p in params] + [feats.grad.numpy()]
    dropped = (~PK.visited_points(grid, active.src, active.bz)).numpy()
    scale = np.abs(true[-1]).max()
    # the dropped sources: 0 in both packages, far from 0 in the true gradient
    assert (grads[-1][dropped] == 0).all() and (want_grads[-1][dropped] == 0).all()
    assert np.abs(true[-1][dropped]).max() > 0.1 * scale
    # the kept sources' gradients agree with the true gradient
    np.testing.assert_allclose(grads[-1][~dropped], true[-1][~dropped], rtol=1e-4,
                               atol=1e-4 * scale)
    # the parameter gradients miss the dropped sources' pairs: the port's and
    # the reference's agree with each other, not with the true gradient
    for i, pname in enumerate(bt.NAMES[:4]):
        top = np.abs(true[i]).max()
        assert np.abs(grads[i] - want_grads[i]).max() <= 3e-2 * top, pname
    assert max(np.abs(grads[i] - true[i]).max() / np.abs(true[i]).max()
               for i in range(4)) > 3e-2


def test_bucket_32k_tool_refuses_without_a_card():
    from mccnn_tpu_torch.tools import bucket_32k

    with pytest.raises(SystemExit, match="no CUDA device"):
        bucket_32k.main(["64", "784"])
