"""The CUDA kernels against their plain versions, and the device routing.

Tests marked ``cuda`` need an NVIDIA GPU and ``nvcc``: they build the kernels
and skip, with a reason, where there is no CUDA device. Run them on the card
with ``python -m pytest tests/port -m cuda``. The unmarked tests check, on the
CPU, that a kernel wrapper refuses what it cannot launch and that unported
sites raise instead of falling back (routing is by shape on every device,
so the CPU walks the card's path).
"""

import math

import numpy as np
import pytest
import torch

from mccnn_tpu_torch.api.builder import SpatialCache
from mccnn_tpu_torch.api.hierarchy import HierarchyLevel, PointHierarchy
from mccnn_tpu_torch.core.buckets import build_buckets
from mccnn_tpu_torch.core.grid import pair_d2, radius_sq
from mccnn_tpu_torch.core.mcconv import init_mcconv_params
from mccnn_tpu_torch.core.pdf import kde_density
from mccnn_tpu_torch.core.sampling import poisson_disk, sweep_cells
from mccnn_tpu_torch.models.layers import MCConv
from mccnn_tpu_torch.ops.cuda import (
    dense_conv,
    dense_probe,
    density_kernel,
    mcconv_kernel,
    poisson_kernel,
    tile_conv,
)
from mccnn_tpu_torch.ops.dispatch import dense_fits, pick_backend


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def cloud(seed, B=2, N=256, masked=13, device="cpu"):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(0, 1, size=(B, N, 3)).astype(np.float32))
    mask = torch.ones((B, N), dtype=torch.bool)
    mask[:, N - masked:] = False
    return pts.to(device), mask.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("N,radius", [(256, 0.2), (40, math.sqrt(3.0) + 0.1)])
def test_kde_kernel_matches_plain(cuda, N, radius):
    pts, mask = cloud(0, N=N, device=cuda)
    got = density_kernel.kde_density_cuda(pts, mask, radius)
    want = density_kernel.kde_density_reference(pts, mask, radius)
    # fp32 sums in another order, expf vs exp
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)


def clustered_cloud(seed, B, N, masked, device):
    """``B`` clouds of ``N`` points in 64 clusters (sigma 0.03) in the unit
    cube, like a scan's surfaces, the last ``masked`` points masked."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0.1, 0.9, size=(B, 64, 3))
    which = rng.integers(0, 64, size=(B, N))
    pts = np.take_along_axis(centres, which[..., None], axis=1)
    pts = (pts + rng.normal(0.0, 0.03, size=(B, N, 3))).astype(np.float32)
    mask = torch.ones((B, N), dtype=torch.bool)
    mask[:, N - masked:] = False
    return torch.from_numpy(pts).to(device), mask.to(device)


K4_CASES = [(8, 8192, 0.05, 0), (8, 8192, 0.1, 0),  # ScanNet's level 0
            (4, 40, math.sqrt(3.0) + 0.1, 3),  # a global level: every group kept
            (2, 1944, 0.3, 1000)]  # a masked tail past half the rows


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["culled", "all_pairs"])
@pytest.mark.parametrize("B,N,radius,masked", K4_CASES)
def test_kde_bodies_match_plain_and_repeat(cuda, body, B, N, radius, masked):
    """Both K4 bodies within rtol 1e-4 of the plain version (fp32 sums in
    another order, expf vs exp), bit for bit on repeat, and with the weight
    off (a count) exactly the plain in-radius count: no in-radius pair falls
    in a culled group."""
    pts, mask = clustered_cloud(20 + N, B, N, masked, cuda)
    got = density_kernel.kde_density_cuda(pts, mask, radius, body=body)
    again = density_kernel.kde_density_cuda(pts, mask, radius, body=body)
    want = density_kernel.kde_density_reference(pts, mask, radius)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)
    counts = density_kernel._launch(pts, mask, radius_sq(radius), 0.0, 1.0, body)
    inr = (pair_d2(pts, pts) <= radius_sq(radius)) & mask[:, None, :]
    assert torch.equal(counts, torch.where(mask, inr.sum(-1).float(), 1.0))


def test_kde_body_by_shape():
    assert density_kernel.pick_body(density_kernel.CULL_MIN_N) == "culled"
    assert density_kernel.pick_body(density_kernel.CULL_MIN_N - 1) == "all_pairs"


def crowded_cloud(seed, B, N, masked, device):
    """``B`` clouds of ``N`` points in 6 tight clusters (sigma 0.004): long
    same-cell runs; the last ``masked`` points masked."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0.2, 0.8, size=(B, 6, 3))
    which = rng.integers(0, 6, size=(B, N))
    pts = np.take_along_axis(centres, which[..., None], axis=1)
    pts = np.clip(pts + rng.normal(0.0, 0.004, size=(B, N, 3)), 0.0, 1.0).astype(np.float32)
    mask = torch.ones((B, N), dtype=torch.bool)
    mask[:, N - masked:] = False
    return torch.from_numpy(pts).to(device), mask.to(device)


K3_CASES = [(2, 256, 0.1, False), (2, 1024, 0.1, False), (2, 300, 0.4, False),
            (2, 1944, 0.15, False),  # ScanNet's level 1
            (1, 4096, 0.1, False),  # tasks.modelnet --points 4096: four points a thread
            (2, 1024, 0.025, False),  # ShapeNet: about 19 bits of cell id
            (2, 2000, 0.1, True)]  # long same-cell runs and a masked tail


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,radius,crowded", K3_CASES)
def test_poisson_kernel_is_bit_equal_to_plain(cuda, B, N, radius, crowded):
    pts, mask = (crowded_cloud(1, B, N, 300, cuda) if crowded
                 else cloud(1, B=B, N=N, device=cuda))
    cids, colors = sweep_cells(pts, radius)
    got = poisson_kernel.poisson_sweep_cuda(pts, mask, cids, colors, radius)
    want = poisson_kernel.poisson_sweep_reference(pts, mask, cids, colors, radius)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,radius", [(2, 300, 0.12), (4, 1024, 0.1), (4, 496, 0.4),
                                        (3, 40, 0.4), (8, 1024, 0.025)])
def test_poisson_variant_kernels_are_bit_equal_to_plain_and_k3(cuda, B, N, radius):
    """K3v2 / K3v3 / K3v4 against their plain versions and K3, bit for bit,
    and bit for bit on repeat (v3 where its layout fits, v4 at each SB that
    folds the batch)."""
    pts, mask = cloud(7, B=B, N=N, masked=N // 7, device=cuda)
    cids, colors = sweep_cells(pts, radius)
    args = (pts, mask, cids, colors, radius)
    k3 = poisson_kernel.poisson_sweep_cuda(*args)
    assert torch.equal(k3, poisson_kernel.poisson_sweep_reference(*args))
    runs = [(poisson_kernel.poisson_sweep_v2_cuda, poisson_kernel.poisson_sweep_v2_reference, {})]
    layout = poisson_kernel.v3_layout(mask, cids, colors)
    if layout.order.shape[1] > poisson_kernel.SWEEP_WINDOW and bool(layout.fits):
        runs.append((poisson_kernel.poisson_sweep_v3_cuda,
                     poisson_kernel.poisson_sweep_v3_reference, {"layout": layout}))
    runs += [(poisson_kernel.poisson_sweep_v4_cuda, poisson_kernel.poisson_sweep_v4_reference,
              {"sb": sb}) for sb in (1, 2, 4) if B % sb == 0]
    for kernel, plain, kw in runs:
        got = kernel(*args, **kw)
        assert torch.equal(got, plain(*args, **kw)), kernel.__name__
        assert torch.equal(got, k3) and torch.equal(kernel(*args, **kw), got), kernel.__name__


@pytest.mark.cuda
def test_poisson_switch_launches_each_variant_kernel(cuda, monkeypatch):
    pts, mask = cloud(8, B=2, N=300, masked=50, device=cuda)
    tight = (0.30 + 0.0015 * torch.rand((1, 300, 3), generator=torch.Generator().manual_seed(0)))
    counters = lambda: (poisson_kernel.launches, poisson_kernel.launches_v2,  # noqa: E731
                        poisson_kernel.launches_v3, poisson_kernel.launches_v4)
    cases = [("v1", pts, mask, (1, 0, 0, 0)), ("v2", pts, mask, (0, 1, 0, 0)),
             ("v3", pts, mask, (0, 0, 1, 0)), ("v42", pts, mask, (0, 0, 0, 1)),
             ("v4", pts, mask, (1, 0, 0, 0)),  # B = 2 does not fold 4 a block: K3
             ("v3", tight.to(cuda), torch.ones((1, 300), dtype=torch.bool, device=cuda),
              (1, 0, 0, 0))]  # one colour run longer than the window: K3
    for variant, p, m, want in cases:
        monkeypatch.setattr(poisson_kernel, "_SWEEP", variant)
        before = counters()
        poisson_disk(p, m, 0.12, 128)
        assert tuple(a - b for a, b in zip(counters(), before)) == want, variant
    monkeypatch.setattr(poisson_kernel, "_SWEEP", "v2")
    big, bmask = cloud(9, B=1, N=1100, masked=0, device=cuda)
    before = counters()
    poisson_disk(big, bmask, 0.12, 128)  # above 1024 points the switch does not apply
    assert tuple(a - b for a, b in zip(counters(), before)) == (1, 0, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,mean", [(1, 16, False), (8, 4, True), (8, None, False),
                                             (8, None, True), (300, 2, False)])
def test_conv_kernel_matches_plain(cuda, c_in, c_out, mean):
    src, smask = cloud(2, N=200, device=cuda)
    smp, qmask = cloud(3, N=70, masked=5, device=cuda)
    g = torch.Generator().manual_seed(4)
    params = init_mcconv_params(g, c_in, c_out, device=cuda)
    feats = torch.randn((2, 200, c_in), generator=g).to(cuda)
    pdf = (torch.rand((2, 200), generator=g) + 0.5).to(cuda)
    args = (params, smp, qmask, src, smask, feats, pdf, 0.3)
    kw = dict(c_out=c_out, mean_normalize=mean, with_count=True)
    before = dense_conv.launches
    with torch.no_grad():
        got, gcnt = dense_conv.dense_mc_conv(*args, **kw)
        want, wcnt = dense_conv.dense_mc_conv_reference(*args, **kw)
    assert dense_conv.launches == before + 1
    assert torch.equal(gcnt, wcnt)
    scale = float(want.abs().max())
    # fp32 sums over neighbours and channels in another order than cuBLAS's
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


def _k2_inputs(device, c_in, c_out):
    src, smask = cloud(2, N=200, device=device)
    smp, qmask = cloud(3, N=70, masked=5, device=device)
    g = torch.Generator().manual_seed(4)
    params = init_mcconv_params(g, c_in, c_out, device=device)
    params = params._replace(b1=(0.1 * torch.randn(8, generator=g)).to(device))
    feats = torch.randn((2, 200, c_in), generator=g).to(device)
    pdf = (torch.rand((2, 200), generator=g) + 0.5).to(device)
    dout = torch.randn((2, 70, c_in if c_out is None else c_out), generator=g).to(device)
    return params, smp, qmask, src, smask, feats, pdf, dout


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,mean", [(1, 16, False), (8, 4, True), (8, None, False),
                                             (8, None, True), (300, 2, False)])
def test_backward_kernel_matches_plain_and_repeats_bitwise(cuda, c_in, c_out, mean):
    params, smp, qmask, src, smask, feats, pdf, dout = _k2_inputs(cuda, c_in, c_out)
    wf = dense_conv._weighted_features(feats, pdf, smask)
    _, cnt, G = dense_conv._forward_reference(params, smp, qmask, src, smask, wf, 0.3,
                                              c_out, mean)
    args = (params, smp, qmask, src, smask, wf, 0.3, G, cnt, dout)
    kw = dict(c_out=c_out, mean_normalize=mean)
    got = dense_conv.dense_mc_conv_backward_cuda(*args, **kw)
    again = dense_conv.dense_mc_conv_backward_cuda(*args, **kw)
    want = dense_conv.dense_mc_conv_backward_reference(*args, **kw)
    torch.cuda.synchronize()
    for name, a, b, w in zip(("d_wf", "dw1", "db1", "dw2", "db2"), got, again, want):
        assert a.shape == w.shape, name
        assert torch.equal(a, b), f"{name}: two calls differ"  # no atomics
        scale = float(w.abs().max())
        # fp32 sums over pairs and channels in another order than the plain version's
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4 * scale, msg=name)


@pytest.mark.cuda
def test_conv_autograd_runs_k1_and_k2(cuda):
    params, smp, qmask, src, smask, feats, pdf, dout = _k2_inputs(cuda, 8, 4)

    def grads(device):
        p = [t.detach().to(device).requires_grad_() for t in params]
        f = feats.detach().to(device).requires_grad_()
        out = dense_conv.dense_mc_conv(
            type(params)(*p), smp.to(device), qmask.to(device), src.to(device),
            smask.to(device), f, pdf.to(device), 0.3, c_out=4)
        (out * dout.to(device)).sum().backward()
        return [t.grad.cpu() for t in (*p, f)]

    before = (dense_conv.launches, dense_conv.backward_launches)
    got = grads(cuda)
    torch.cuda.synchronize()
    assert (dense_conv.launches, dense_conv.backward_launches) == (before[0] + 1, before[1] + 1)
    for g, w in zip(got, grads("cpu")):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))


def _sphere(seed, B, N, device):
    """Points on a sphere of radius 0.45 about the cube's centre: a surface
    like a normalised shape's, where a radius of 0.025 meets a few points."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(B, N, 3))
    v = 0.5 + 0.45 * v / np.linalg.norm(v, axis=-1, keepdims=True)
    return torch.from_numpy(v.astype(np.float32)).to(device)


# (name, B, N sources, M samples, C, CO, radius): the pair kernels' cases that
# test what the lists, their rounds and the block shapes do. "stem" / "dec"
# are ShapeNet's 1024 -> 1024 sites (samples = sources); "masked" masks whole
# sample and source tiles; "overflow" gives every sample 1000 in-radius
# sources, more than a list holds; "global" is M = 1 at the global radius
# with C = 256; "c1" is C = 1 (K1's rows spread over threads); "passes" runs
# four passes of 64 channels over two staged chunks and many rounds each.
GLOBAL_R = math.sqrt(3.0) + 0.1
PAIR_CASES = [("stem", 2, 1024, 1024, 17, 64, 0.025), ("dec", 2, 1024, 1024, 256, None, 0.05),
              ("masked", 2, 300, 200, 8, 4, 0.3), ("overflow", 1, 1000, 8, 4, 8, GLOBAL_R),
              ("global", 3, 40, 1, 256, 64, GLOBAL_R), ("c1", 2, 256, 70, 1, 16, 0.3),
              ("passes", 1, 1100, 1100, 256, None, GLOBAL_R)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,N,M,C,CO,radius", PAIR_CASES, ids=[c[0] for c in PAIR_CASES])
def test_pair_kernels_match_plain_on_their_edge_cases(cuda, name, B, N, M, C, CO, radius):
    """K1 and K2 against their plain versions where the in-radius lists, their
    rounds, skipped tiles and channel slices matter: G, counts and every
    gradient, bit for bit on repeat; a skipped tile writes zero rows of G
    into memory the allocator last held NaN in, and no NaN reaches dW2."""
    g = torch.Generator().manual_seed(11)
    src = _sphere(12, B, N, cuda)
    smp = src if N == M else _sphere(13, B, M, cuda)
    smask = torch.ones((B, N), dtype=torch.bool, device=cuda)
    qmask = torch.ones((B, M), dtype=torch.bool, device=cuda)
    if name == "masked":  # a whole sample tile and a whole source tile of padding
        qmask[:, :64] = False
        qmask[1, 150:] = False
        smask[:, 32:128] = False
    params = init_mcconv_params(g, C, CO, device=cuda)
    params = params._replace(b1=(0.1 * torch.randn(8, generator=g)).to(cuda))
    feats = torch.randn((B, N, C), generator=g).to(cuda)
    pdf = (torch.rand((B, N), generator=g) + 0.5).to(cuda)
    wf = dense_conv._weighted_features(feats, pdf, smask)
    fargs = (params, smp, qmask, src, smask, wf, radius, CO, False)
    nan = torch.full((B, M, 9, C), float("nan"), device=cuda)
    del nan  # G's torch.empty may now reuse NaN memory
    before = (dense_conv.launches, dense_conv.backward_launches)
    out, cnt, G = dense_conv._forward_cuda(*fargs)
    out2, cnt2, G2 = dense_conv._forward_cuda(*fargs)
    want, wcnt, wG = dense_conv._forward_reference(*fargs)
    torch.cuda.synchronize()
    assert torch.equal(G, G2) and torch.equal(out, out2)  # no atomics
    assert torch.equal(cnt, wcnt)
    assert not torch.isnan(G).any()
    assert torch.equal(G[~qmask], torch.zeros_like(G[~qmask]))
    # fp32 sums over neighbours and channels in another order than the plain version's
    for got, ref in ((G, wG), (out, want)):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
    dout = torch.randn(out.shape, generator=g).to(cuda)
    bargs = (params, smp, qmask, src, smask, wf, radius, G, cnt, dout)
    got = dense_conv.dense_mc_conv_backward_cuda(*bargs, c_out=CO)
    again = dense_conv.dense_mc_conv_backward_cuda(*bargs, c_out=CO)
    # the plain backward with pre_h rounded as mc_preact: the ReLU steps fall
    # as in the kernel at every one of these pairs
    terms = dense_conv._pair_terms(params, smp, qmask, src, smask, radius, kernel_rounding=True)
    t = dout * dense_conv._scale(cnt, qmask, False)[..., None]
    ref = dense_conv._backward_reference(params, *terms, wf, G, t, CO)
    torch.cuda.synchronize()
    assert (dense_conv.launches, dense_conv.backward_launches) == (before[0] + 2, before[1] + 2)
    for part, a, a2, w in zip(("d_wf", "dw1", "db1", "dw2", "db2"), got, again, ref):
        assert torch.equal(a, a2), f"{part}: two calls differ"
        assert torch.isfinite(a).all(), part
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()), msg=part)
    assert torch.equal(got[0][~smask], torch.zeros_like(got[0][~smask]))


# (name, c_in, c_out, mean, geometry): K1v1 / K2v1's cases. "base" is
# _k2_inputs at r 0.3; the others are (B, N sources, M samples, radius) on
# _sphere clouds: "overflow" gives every sample all 1000 sources and every
# source all 600 samples in radius, more than a list holds, so the sweeps
# resume in rounds; "masked" masks whole groups of 32 samples and sources;
# "global" is the M = 1 site at C = 256, CO = 1024; "stem" the C = 1 stem
# at CO = 128.
V1_CASES = [("base", 1, 16, False, None), ("base", 8, 4, True, None),
            ("base", 8, None, False, None), ("base", 8, None, True, None),
            ("base", 300, 2, False, None), ("base", 40, 600, False, None),
            ("overflow", 4, 8, False, (1, 1000, 8, GLOBAL_R)),
            ("overflow", 16, None, True, (1, 600, 600, GLOBAL_R)),
            ("masked", 8, 4, False, (2, 300, 200, 0.3)),
            ("masked", 64, None, True, (2, 300, 200, 0.3)),
            ("global", 256, 1024, False, (3, 40, 1, GLOBAL_R)),
            ("stem", 1, 128, False, (2, 256, 70, 0.3))]


def _v1_inputs(device, name, c_in, c_out, geometry):
    """``(params, smp, qmask, src, smask, wf, dout, radius)`` of a V1_CASES case."""
    if geometry is None:
        params, smp, qmask, src, smask, feats, pdf, dout = _k2_inputs(device, c_in, c_out)
        return (params, smp, qmask, src, smask, dense_conv._weighted_features(feats, pdf, smask),
                dout, 0.3)
    B, N, M, radius = geometry
    g = torch.Generator().manual_seed(17)
    src = _sphere(18, B, N, device)
    smp = src if N == M else _sphere(19, B, M, device)
    smask = torch.ones((B, N), dtype=torch.bool, device=device)
    qmask = torch.ones((B, M), dtype=torch.bool, device=device)
    if name == "masked":  # whole groups of 32 padding points on both sides
        qmask[:, :64] = False
        qmask[1, 150:] = False
        smask[:, 32:128] = False
    params = init_mcconv_params(g, c_in, c_out, device=device)
    params = params._replace(b1=(0.1 * torch.randn(8, generator=g)).to(device),
                             b2=(0.1 * torch.randn(params.b2.shape, generator=g)).to(device))
    feats = torch.randn((B, N, c_in), generator=g).to(device)
    pdf = (torch.rand((B, N), generator=g) + 0.5).to(device)
    dout = torch.randn((B, M, c_in if c_out is None else c_out), generator=g).to(device)
    return (params, smp, qmask, src, smask, dense_conv._weighted_features(feats, pdf, smask),
            dout, radius)


@pytest.mark.cuda
@pytest.mark.parametrize("name,c_in,c_out,mean,geometry", V1_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}" for c in V1_CASES])
def test_v1_kernels_match_plain_and_k1_k2_and_repeat_bitwise(cuda, name, c_in, c_out, mean,
                                                             geometry):
    """K1v1 against its plain version and K1, K2v1 against its plain version
    and bit for bit against K2 on K1's G (K2v1 forms the same G rows and runs
    K2's kernels on them), both bit for bit on repeat; two K2v1 calls move
    only K2v1's counter."""
    params, smp, qmask, src, smask, wf, dout, radius = _v1_inputs(cuda, name, c_in, c_out,
                                                                  geometry)
    fargs = (params, smp, qmask, src, smask, wf, radius, c_out, mean)
    before = (dense_conv.launches_v1, dense_conv.backward_launches_v1)
    out, cnt = dense_conv._forward_cuda_v1(*fargs)
    again, _ = dense_conv._forward_cuda_v1(*fargs)
    want, wcnt, _ = dense_conv._forward_reference(*fargs)
    k1, k1cnt, G1 = dense_conv._forward_cuda(*fargs)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(cnt, wcnt) and torch.equal(cnt, k1cnt)
    assert torch.isfinite(out).all()
    scale = float(want.abs().max())
    # fp32 sums over neighbours and channels in other orders (TF32 off)
    for ref in (want, k1):
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * scale)
    bargs = (params, smp, qmask, src, smask, wf, radius, cnt, dout)
    kw = dict(c_out=c_out, mean_normalize=mean)
    k2 = dense_conv.dense_mc_conv_backward_cuda(params, smp, qmask, src, smask, wf, radius, G1,
                                                cnt, dout, **kw)
    torch.cuda.synchronize()
    k12 = (dense_conv.launches, dense_conv.backward_launches)
    got = dense_conv.dense_mc_conv_v1_backward_cuda(*bargs, **kw)
    again = dense_conv.dense_mc_conv_v1_backward_cuda(*bargs, **kw)
    torch.cuda.synchronize()
    assert (dense_conv.launches, dense_conv.backward_launches) == k12
    want = dense_conv.dense_mc_conv_v1_backward_reference(*bargs, **kw)
    assert (dense_conv.launches_v1, dense_conv.backward_launches_v1) == (before[0] + 2,
                                                                         before[1] + 2)
    for part, a, a2, w, w2 in zip(("d_wf", "dw1", "db1", "dw2", "db2"), got, again, want, k2):
        assert a.shape == w.shape, part
        assert torch.equal(a, a2), f"{part}: two calls differ"
        assert torch.equal(a, w2), f"{part}: differs from K2 on K1's G"
        assert torch.isfinite(a).all(), part
        # fp32 sums over pairs, channels and partials in other orders; the
        # plain version rounds pre_h as mc_preact does (the same ReLU steps)
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()), msg=part)
    assert torch.equal(got[0][~smask], torch.zeros_like(got[0][~smask]))


@pytest.mark.cuda
def test_v1_route_runs_k1v1_and_k2v1(cuda, monkeypatch):
    monkeypatch.setattr(dense_conv, "_USE_V1", True)
    params, smp, qmask, src, smask, feats, pdf, dout = _k2_inputs(cuda, 8, 4)

    def grads(device):
        p = [t.detach().to(device).requires_grad_() for t in params]
        f = feats.detach().to(device).requires_grad_()
        out = dense_conv.dense_mc_conv(
            type(params)(*p), smp.to(device), qmask.to(device), src.to(device),
            smask.to(device), f, pdf.to(device), 0.3, c_out=4)
        (out * dout.to(device)).sum().backward()
        return [t.grad.cpu() for t in (*p, f)]

    counters = lambda: (dense_conv.launches, dense_conv.backward_launches,  # noqa: E731
                        dense_conv.launches_v1, dense_conv.backward_launches_v1)
    before = counters()
    got = grads(cuda)
    torch.cuda.synchronize()
    assert counters() == (before[0], before[1], before[2] + 1, before[3] + 1)
    for g, w in zip(got, grads("cpu")):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))


def test_v1_wrappers_refuse_cpu_tensors():
    pts, mask = cloud(6, N=32)
    params = init_mcconv_params(torch.Generator().manual_seed(0), 1, 2)
    feats = torch.ones((2, 32, 1))
    calls = [
        lambda: dense_conv._forward_cuda_v1(params, pts, mask, pts, mask, feats, 0.2, 2, False),
        lambda: dense_conv.dense_mc_conv_v1_backward_cuda(
            params, pts, mask, pts, mask, feats, 0.2, torch.ones((2, 32)),
            torch.ones((2, 32, 2)), c_out=2),
    ]
    before = (dense_conv.launches_v1, dense_conv.backward_launches_v1)
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert (dense_conv.launches_v1, dense_conv.backward_launches_v1) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    pts, mask = cloud(6, N=32)
    cids, colors = sweep_cells(pts, 0.2)
    params = init_mcconv_params(torch.Generator().manual_seed(0), 1, 2)
    feats = torch.ones((2, 32, 1))
    calls = [
        lambda: density_kernel.kde_density_cuda(pts, mask, 0.2),
        lambda: poisson_kernel.poisson_sweep_cuda(pts, mask, cids, colors, 0.2),
        lambda: dense_conv._forward_cuda(params, pts, mask, pts, mask, feats, 0.2, 2, False),
        lambda: dense_conv.dense_mc_conv_backward_cuda(
            params, pts, mask, pts, mask, feats, 0.2, torch.zeros((2, 32, 9, 1)),
            torch.ones((2, 32)), torch.ones((2, 32, 2)), c_out=2),
    ]
    counters = lambda: (density_kernel.launches, poisson_kernel.launches,  # noqa: E731
                        dense_conv.launches, dense_conv.backward_launches)
    before = counters()
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert counters() == before


def test_poisson_variant_wrappers_refuse_cpu_tensors():
    pts, mask = cloud(6, N=300)
    cids, colors = sweep_cells(pts, 0.2)
    args = (pts, mask, cids, colors, 0.2)
    calls = [lambda: poisson_kernel.poisson_sweep_v2_cuda(*args),
             lambda: poisson_kernel.poisson_sweep_v3_cuda(*args),
             lambda: poisson_kernel.poisson_sweep_v4_cuda(*args, sb=2)]
    counters = lambda: (poisson_kernel.launches_v2, poisson_kernel.launches_v3,  # noqa: E731
                        poisson_kernel.launches_v4)
    before = counters()
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert counters() == before


def test_tile_kernel_wrappers_refuse_cpu_tensors():
    pts, mask = cloud(6, N=160)
    params = init_mcconv_params(torch.Generator().manual_seed(0), 2, None)
    lay = tile_conv.conv_layout(pts, mask, pts, mask, 0.2, max_pairs=1 << 30, backward=True)
    wf = tile_conv._sorted_weighted_features(lay, torch.ones((2, 160, 2)), torch.ones((2, 160)))
    cnt, dout = torch.ones((2, 256)), torch.ones((2, 256, 2))
    sweep = tile_conv.make_cover_sweep(pts, mask, 0.2, max_pairs=1 << 30)
    calls = [
        lambda: tile_conv.tile_conv_sorted_cuda(params, lay, wf, 0.2),
        lambda: tile_conv.tile_conv_backward_sorted_cuda(params, lay, wf, 0.2, cnt, dout),
        lambda: tile_conv.tile_kde_sums_cuda(sweep.layout, 0.2),
        lambda: tile_conv.cover_counts_cuda(sweep.layout, sweep.valid, 0.2),
    ]
    counters = lambda: (tile_conv.launches, tile_conv.backward_launches,  # noqa: E731
                        tile_conv.kde_launches, tile_conv.cover_launches)
    before = counters()
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert counters() == before


def test_unported_sites_raise():
    # Routing is by shape on every device: the CPU takes the card's path.
    assert not dense_fits(4096, 128, 128)
    assert pick_backend(4096, 0.1, 128, 128) == "bucket"  # -> tile with a capacity
    assert pick_backend(4096, 0.5, 128, 128) == "jnp"  # the K-capacity conv
    assert pick_backend(64, 0.1, 8, None, mode="tile") == "tile"
    for site in [(1024, 1, 128, 496), (496, 128, 256, 40), (40, 256, 1024, 1)]:
        # MCClassS's three sites sit inside the envelope
        assert pick_backend(site[0], 0.2, site[1], site[2], site[3]) == "dense"
    # The tile and bucket sites are ported; the K-capacity conv raises.
    pts, mask = cloud(5, B=1, N=64, masked=0)
    level = HierarchyLevel(points=pts, mask=mask, radius=0.0, sample=None)
    hier = PointHierarchy(levels=(level, level))
    feats = torch.ones((1, 64, 4))
    with pytest.raises(NotImplementedError, match="K-capacity"):
        MCConv(4, None)(SpatialCache(hier, conv_backend="jnp"), 0, 1, 0.2, feats)
    for cache in (SpatialCache(hier, conv_backend="bucket"),  # the bucket conv
                  SpatialCache(hier, tile_pairs=1 << 30, conv_backend="bucket")):  # -> tile
        assert MCConv(4, None)(cache, 0, 1, 0.2, feats).shape == (1, 64, 4)
    big = torch.zeros((1, 8193, 3))
    with pytest.raises(NotImplementedError, match="K-capacity"):
        kde_density(big, torch.ones((1, 8193), dtype=torch.bool), 0.1)
    # the neighbour-list sampler takes N > 4096 without a tile capacity
    ss = poisson_disk(big[:, :4097], torch.ones((1, 4097), dtype=torch.bool), 0.1, 64)
    assert int(ss.mask.sum()) == 1  # 4097 copies of one point: one selection


# ------------------------------------------------------------ the bucket kernels


def _bucket_inputs(device, c_in, c_out, cap_p=32, cap_s=16, scale=1.0, n_src=300):
    """Two clouds of ``n_src`` sources and 90 samples (a masked tail in each)
    in layouts at r = 0.25 (R = 4); ``cap_p = 8`` overflows source cells of
    300 sources, and 48 sources leave 1-3 in each occupied cell. ``scale`` <
    1 crowds the sources into a few cells and takes them as the samples too,
    so that a cell of more than 128 slots spans several kernel blocks on both
    sides."""
    src, smask = cloud(2, N=n_src, device=device)
    smp, qmask = cloud(3, N=90, masked=5, device=device)
    if scale < 1:
        src = src * scale
        smp, qmask = src, smask
    gp = build_buckets(src, smask, 0.25, cap_p)
    gs = build_buckets(smp, qmask, 0.25, cap_s)
    g = torch.Generator().manual_seed(4)
    params = init_mcconv_params(g, c_in, c_out, device=device)
    params = params._replace(b1=(0.1 * torch.randn(8, generator=g)).to(device))
    feats = torch.randn((2, n_src, c_in), generator=g).to(device)
    pdf = (torch.rand((2, n_src), generator=g) + 0.5).to(device)
    wf = torch.where(mcconv_kernel.kept_points(gp)[..., None], feats / pdf[..., None], 0.0)
    dout = torch.randn((2, smp.shape[1], c_in if c_out is None else c_out), generator=g)
    dout = dout.to(device)
    return params, gs, gp, wf, dout


BUCKET_CASES = [  # c_in, c_out, mean, cap_p, cap_s, scale, n_src
    (1, 16, False, 32, 16, 1.0, 300), (8, None, True, 32, 16, 1.0, 300),
    (8, None, False, 8, 16, 1.0, 300), (40, 3, True, 8, 16, 1.0, 300),
    (4, None, False, 136, 136, 0.3, 300), (2, 5, True, 136, 136, 0.3, 300),
    # K10 blocks over all channels: passes of 4 * 256 / owners channels (the
    # crowded cells' lists fill and take several rounds, X kept between them),
    # the full site 1 -> 64, and 1-3 kept sources a cell
    (256, None, False, 32, 16, 1.0, 300), (384, None, True, 136, 136, 0.3, 300),
    (1, 64, False, 32, 16, 1.0, 300), (64, None, False, 8, 16, 1.0, 48),
    # K9's full conv at C <= 4 spreads a sample's rows over threads, here with
    # crowded cells whose lists fill (every window pair in radius)
    (1, 128, True, 136, 136, 0.3, 300), (3, 16, False, 32, 16, 1.0, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,mean,cap_p,cap_s,scale,n_src", BUCKET_CASES)
def test_bucket_conv_kernel_matches_plain_and_repeats_bitwise(cuda, c_in, c_out, mean, cap_p,
                                                              cap_s, scale, n_src):
    params, gs, gp, wf, _ = _bucket_inputs(cuda, c_in, c_out, cap_p, cap_s, scale, n_src)
    # the small cap drops sources, and so do the crowded cells
    assert (int(gp.overflow.max()) > 0) == ((cap_p == 8 and n_src == 300) or scale < 1)
    if n_src < 300:  # 1-3 kept sources a cell
        assert int(gp.cell_count.max()) == 3
    if scale < 1:  # cells of more than 128 kept points: several blocks a cell
        assert int(gp.cell_count.max()) > 128 and int(gs.cell_count.max()) > 128
    kw = dict(c_out=c_out, mean_normalize=mean)
    before = mcconv_kernel.launches
    got, gcnt = mcconv_kernel.bucket_conv_cuda(params, gs, gp, wf, **kw)
    again, _ = mcconv_kernel.bucket_conv_cuda(params, gs, gp, wf, **kw)
    want, wcnt = mcconv_kernel.bucket_conv_reference(params, gs, gp, wf, **kw)
    torch.cuda.synchronize()
    assert mcconv_kernel.launches == before + 2
    assert torch.equal(got, again) and torch.equal(gcnt, wcnt)
    # fp32 sums over the window's pairs and channels in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,mean,cap_p,cap_s,scale,n_src", BUCKET_CASES)
def test_bucket_conv_backward_kernel_matches_plain_and_repeats_bitwise(cuda, c_in, c_out, mean,
                                                                       cap_p, cap_s, scale, n_src):
    params, gs, gp, wf, dout = _bucket_inputs(cuda, c_in, c_out, cap_p, cap_s, scale, n_src)
    kw = dict(c_out=c_out, mean_normalize=mean)
    _, cnt = mcconv_kernel.bucket_conv_reference(params, gs, gp, wf, **kw)
    args = (params, gs, gp, wf, cnt, dout)
    before = mcconv_kernel.backward_launches
    got = mcconv_kernel.bucket_conv_backward_cuda(*args, **kw)
    again = mcconv_kernel.bucket_conv_backward_cuda(*args, **kw)
    want = mcconv_kernel.bucket_conv_backward_reference(*args, **kw)
    torch.cuda.synchronize()
    assert mcconv_kernel.backward_launches == before + 2
    for name, a, b, w in zip(("d_wf", "dw1", "db1", "dw2", "db2"), got, again, want):
        assert a.shape == w.shape, name
        assert torch.equal(a, b), f"{name}: two calls differ"  # no atomics
        # fp32 sums in another order; the plain version rounds pre_h as the
        # kernel does, so no pair's ReLU step falls differently
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()), msg=name)


ACTIVE_CASES = [  # c_in, c_out, mean, cap_p, cap_s, scale, n_src
    (8, None, False, 32, 16, 1.0, 300), (8, None, True, 8, 16, 1.0, 300),
    (40, 3, True, 32, 16, 1.0, 300), (1, 16, False, 8, 16, 1.0, 300),
    (4, None, True, 136, 136, 0.3, 300), (2, 5, False, 136, 136, 0.3, 300),
    (256, None, False, 136, 136, 0.3, 300), (1, 64, True, 32, 16, 1.0, 300),
    (64, None, False, 8, 16, 1.0, 48), (384, None, True, 136, 136, 0.3, 300),
    (1, 128, False, 136, 136, 0.3, 300)]


def _bricks(gs, gp, nba):
    bz = mcconv_kernel.pick_bz(gs.res, min(gs.cap, gp.cap))
    return mcconv_kernel.ActiveBricks(mcconv_kernel._brick_activity(gs, bz, nba),
                                      mcconv_kernel._brick_activity(gp, bz, nba), bz)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,mean,cap_p,cap_s,scale,n_src", ACTIVE_CASES)
def test_bucket_active_kernels_match_plain_and_k9_k10(cuda, c_in, c_out, mean, cap_p, cap_s,
                                                      scale, n_src):
    """K9a / K10a at an NBA that visits every occupied brick: bit for bit K9
    / K10 and bit for bit on repeat; at an NBA that drops bricks: their plain
    versions, with exact zeros at the dropped samples and sources."""
    params, gs, gp, wf, dout = _bucket_inputs(cuda, c_in, c_out, cap_p, cap_s, scale, n_src)
    kw = dict(c_out=c_out, mean_normalize=mean)
    mk = mcconv_kernel
    bz = mk.pick_bz(gs.res, min(cap_s, cap_p))
    occupied = max(int(mk.brick_occupancy(g, bz).sum(dim=-1).max()) for g in (gs, gp))
    lossless = _bricks(gs, gp, occupied)
    before = (mk.launches_active, mk.backward_launches_active)
    got, gcnt = mk.bucket_conv_active_cuda(params, gs, gp, wf, lossless, **kw)
    again, _ = mk.bucket_conv_active_cuda(params, gs, gp, wf, lossless, **kw)
    k9, k9cnt = mk.bucket_conv_cuda(params, gs, gp, wf, **kw)
    args = (params, gs, gp, wf, gcnt, dout)
    gb = mk.bucket_conv_backward_active_cuda(*args, lossless, **kw)
    gb2 = mk.bucket_conv_backward_active_cuda(*args, lossless, **kw)
    k10 = mk.bucket_conv_backward_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert (mk.launches_active, mk.backward_launches_active) == (before[0] + 2, before[1] + 2)
    assert torch.equal(got, again) and torch.equal(got, k9) and torch.equal(gcnt, k9cnt)
    for name, a, b, w in zip(("d_wf", "dw1", "db1", "dw2", "db2"), gb, gb2, k10):
        assert torch.equal(a, b), f"{name}: two calls differ"
        assert torch.equal(a, w), f"{name}: K10a differs from K10 at a lossless NBA"
    lossy = _bricks(gs, gp, max(1, occupied - 3))
    got, gcnt = mk.bucket_conv_active_cuda(params, gs, gp, wf, lossy, **kw)
    want, wcnt = mk.bucket_conv_active_reference(params, gs, gp, wf, lossy, **kw)
    dropped = mk.kept_points(gs) & ~mk.visited_points(gs, lossy.smp, bz)
    assert bool(dropped.any()) and torch.equal(gcnt, wcnt)
    assert bool((got[dropped] == 0).all()) and bool((gcnt[dropped] == 0).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    args = (params, gs, gp, wf, gcnt, dout, lossy)
    gb = mk.bucket_conv_backward_active_cuda(*args, **kw)
    want = mk.bucket_conv_backward_active_reference(*args, **kw)
    gone = mk.kept_points(gp) & ~mk.visited_points(gp, lossy.src, bz)
    assert bool(gone.any()) and bool((gb[0][gone] == 0).all())
    for name, a, w in zip(("d_wf", "dw1", "db1", "dw2", "db2"), gb, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()), msg=name)


def test_bucket_active_kernel_wrappers_refuse_cpu_tensors():
    params, gs, gp, wf, dout = _bucket_inputs("cpu", 2, None)
    cnt = torch.ones(dout.shape[:2])
    active = _bricks(gs, gp, 3)
    mk = mcconv_kernel
    before = (mk.launches_active, mk.backward_launches_active)
    for call in (lambda: mk.bucket_conv_active_cuda(params, gs, gp, wf, active),
                 lambda: mk.bucket_conv_backward_active_cuda(params, gs, gp, wf, cnt, dout,
                                                             active)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert (mk.launches_active, mk.backward_launches_active) == before


def test_bucket_kernel_wrappers_refuse_cpu_tensors():
    params, gs, gp, wf, dout = _bucket_inputs("cpu", 2, None)
    cnt = torch.ones(dout.shape[:2])
    before = (mcconv_kernel.launches, mcconv_kernel.backward_launches)
    for call in (lambda: mcconv_kernel.bucket_conv_cuda(params, gs, gp, wf),
                 lambda: mcconv_kernel.bucket_conv_backward_cuda(params, gs, gp, wf, cnt, dout)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert (mcconv_kernel.launches, mcconv_kernel.backward_launches) == before


# ------------------------------------------------------------ the tile kernels


def _tile_conv_case(device, c_in, c_out, M=300, N=700, masked=20):
    src, smask = cloud(7, N=N, masked=60, device=device)
    smp, qmask = cloud(8, N=M, masked=masked, device=device)
    g = torch.Generator().manual_seed(9)
    params = init_mcconv_params(g, c_in, c_out, device=device)
    params = params._replace(b1=(0.1 * torch.randn(8, generator=g)).to(device))
    feats = torch.randn((2, N, c_in), generator=g).to(device)
    pdf = (torch.rand((2, N), generator=g) + 0.5).to(device)
    return params, smp, qmask, src, smask, feats, pdf


# K5's cases: c_in, c_out, mean, max_steps (a short budget drops steps),
# radius, minor, step chunk, masked samples (of 300). Every case's clouds
# (2 x 3 sample tiles) would not fill the card, so C > 4 splits the channels
# over blocks; the full conv at C <= 4 spreads the rows over threads (1 -> 16,
# 1 -> 64); C = 1024 at r = 0.5 takes three passes of 64 channels a slice
# whose lists fill (a sample meets about 200 sources), so each pass sweeps
# again; at r = 0.4 the 32-sample blocks' lists (C <= 32) fill and take
# several rounds; chunk 16 makes steps of 2048 rows, two staged chunks a
# step; 200 masked samples leave the last two tiles with no valid sample.
TILE_FWD_CASES = [(1, 16, False, None, 0.2, "32", 8, 20), (8, None, True, None, 0.2, "32", 8, 20),
                  (40, None, False, None, 0.2, "32", 8, 20), (8, 4, False, 2, 0.2, "32", 8, 20),
                  (1, 64, False, None, 0.2, "32", 8, 20), (64, None, False, None, 0.2, "8", 8, 20),
                  (256, None, True, None, 0.2, "128", 8, 20),
                  (384, None, False, None, 0.4, "32", 16, 20),
                  (1024, None, True, None, 0.5, "32", 8, 20),
                  (8, None, False, None, 0.4, "8", 16, 200),
                  (1, 64, True, None, 0.4, "128", 16, 200), (3, 5, True, 2, 0.4, "8", 8, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,mean,max_steps,radius,minor,chunk,masked", TILE_FWD_CASES)
def test_tile_conv_kernel_matches_plain_and_repeats_bitwise(cuda, monkeypatch, c_in, c_out, mean,
                                                            max_steps, radius, minor, chunk,
                                                            masked):
    monkeypatch.setattr(tile_conv, "_MINOR", minor)
    params, smp, qmask, src, smask, feats, pdf = _tile_conv_case(cuda, c_in, c_out,
                                                                 masked=masked)
    lay = tile_conv.conv_layout(smp, qmask, src, smask, radius, max_pairs=1 << 30,
                                max_steps=max_steps, chunk=chunk)
    assert lay.steps.Tm == int(minor) and lay.steps.j_ids.shape[1] * int(minor) == 128 * chunk
    wf = tile_conv._sorted_weighted_features(lay, feats, pdf)
    kw = dict(c_out=c_out, mean_normalize=mean)
    before = (tile_conv.launches, tile_conv.packed_launches)
    got, gcnt = tile_conv.tile_conv_sorted_cuda(params, lay, wf, radius, **kw)
    again, _ = tile_conv.tile_conv_sorted_cuda(params, lay, wf, radius, **kw)
    packed, pcnt = tile_conv.tile_conv_sorted_packed_cuda(params, lay, wf, radius, **kw)
    want, wcnt = tile_conv.tile_conv_sorted_reference(params, lay, wf, radius, **kw)
    torch.cuda.synchronize()
    assert (tile_conv.launches, tile_conv.packed_launches) == (before[0] + 2, before[1] + 1)
    assert torch.equal(got, again)  # one writer per output, fixed order
    assert torch.equal(packed, got) and torch.equal(pcnt, gcnt)  # K5p stages K5's values
    assert torch.equal(gcnt, wcnt)
    if masked > 128:  # a whole tile of invalid samples: written, zero
        dead = ~lay.smp_valid.reshape(2, -1, 128).any(dim=-1)
        assert bool(dead.any())
        assert bool((got.reshape(2, -1, 128, got.shape[-1])[dead] == 0).all())
    scale = float(want.abs().max())
    # fp32 sums over the step list's pairs and channels in another order
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    if max_steps:
        assert int(lay.overflow.max()) > 0


@pytest.mark.cuda
def test_tile_conv_and_dense_conv_agree_through_the_public_functions(cuda):
    params, smp, qmask, src, smask, feats, pdf = _tile_conv_case(cuda, 8, None)
    with torch.no_grad():
        got = tile_conv.tile_mc_conv(params, smp, qmask, src, smask, feats, pdf, 0.2,
                                     max_pairs=1 << 30)
        want = dense_conv.dense_mc_conv(params, smp, qmask, src, smask, feats, pdf, 0.2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


# K6's cases: c_in, c_out, mean, max_steps (a short budget drops steps: X
# follows the backward list), radius, minor. C = 256 and 384 take several
# passes of 64 channels and split the channels over blocks; at r = 0.4 a
# source meets about 75 samples, so its list fills and takes several rounds
# (with several passes, X is kept between them: in xs depthwise, in X full)
TILE_BWD_CASES = [(8, None, False, None, 0.2, "32"), (1, 16, False, None, 0.2, "32"),
                  (40, None, True, None, 0.2, "32"), (8, None, False, 2, 0.2, "32"),
                  (3, 5, True, 2, 0.2, "32"), (256, None, False, None, 0.2, "32"),
                  (384, None, True, None, 0.2, "32"), (1, 64, False, None, 0.2, "32"),
                  (8, None, False, None, 0.4, "32"), (256, None, True, None, 0.4, "32"),
                  (1, 256, False, None, 0.4, "32"), (64, None, False, None, 0.2, "8"),
                  (1, 64, True, None, 0.4, "128"), (256, None, False, 2, 0.4, "8")]


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,mean,max_steps,radius,minor", TILE_BWD_CASES)
def test_tile_conv_backward_kernel_matches_plain_and_repeats_bitwise(cuda, monkeypatch, c_in,
                                                                     c_out, mean, max_steps,
                                                                     radius, minor):
    monkeypatch.setattr(tile_conv, "_MINOR", minor)
    params, smp, qmask, src, smask, feats, pdf = _tile_conv_case(cuda, c_in, c_out)
    lay = tile_conv.conv_layout(smp, qmask, src, smask, radius, max_pairs=1 << 30,
                                max_steps=max_steps, backward=True)
    assert lay.steps_b.Tm == int(minor)
    wf = tile_conv._sorted_weighted_features(lay, feats, pdf)
    kw = dict(c_out=c_out, mean_normalize=mean)
    out, cnt = tile_conv.tile_conv_sorted_reference(params, lay, wf, radius, **kw)
    g = torch.Generator().manual_seed(10)
    dout = torch.randn(out.shape, generator=g).to(cuda)
    args = (params, lay, wf, radius, cnt, dout)
    before = tile_conv.backward_launches
    got = tile_conv.tile_conv_backward_sorted_cuda(*args, **kw)
    again = tile_conv.tile_conv_backward_sorted_cuda(*args, **kw)
    want = tile_conv.tile_conv_backward_sorted_reference(*args, **kw)
    torch.cuda.synchronize()
    assert tile_conv.backward_launches == before + 2
    for name, a, a2, w in zip(("d_wf", "dw1", "db1", "dw2", "db2"), got, again, want):
        assert a.shape == w.shape, name
        assert torch.equal(a, a2), name  # one writer per output, fixed-order reductions
        scale = float(w.abs().max())
        assert scale > 0, name
        # fp32 sums over the backward list's pairs and channels in another order;
        # the plain version rounds pre_h as the kernel does, so no ReLU step flips
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4 * scale, msg=name)
    if max_steps:
        assert int(lay.overflow.max()) > 0


@pytest.mark.cuda
def test_loss_backward_through_tile_mc_conv_launches_k5_and_k6(cuda):
    case = _tile_conv_case(cuda, 6, 4)
    g = torch.Generator().manual_seed(11)
    cot = torch.randn((2, 300, 4), generator=g)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        params, smp, qmask, src, smask, feats, pdf = (
            type(case[0])(*(t.to(dev) for t in case[0])), *(t.to(dev) for t in case[1:]))
        params = type(params)(*(t.detach().requires_grad_() for t in params))
        feats = feats.detach().requires_grad_()
        before = (tile_conv.launches, tile_conv.backward_launches)
        out = tile_conv.tile_mc_conv(params, smp, qmask, src, smask, feats, pdf, 0.2,
                                     max_pairs=1 << 30, c_out=4)
        (out * cot.to(dev)).sum().backward()
        moved = (tile_conv.launches - before[0], tile_conv.backward_launches - before[1])
        assert moved == ((1, 1) if dev.type == "cuda" else (0, 0))
        grads[dev.type] = [t.grad.cpu() for t in (*params, feats)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        # the same plain-vs-kernel sums as above, through the unsort and f / pdf
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("N,radius,chunk", [(700, 0.2, 8), (2100, 0.1, 8),
                                            (2100, 0.05, 1)])  # 200-odd inert steps a cloud
def test_tile_kde_kernel_matches_plain_and_dense(cuda, N, radius, chunk):
    pts, mask = cloud(10, N=N, masked=50, device=cuda)
    lay = tile_conv.self_layout(pts, mask, radius, max_pairs=1 << 30, chunk=chunk)
    before = tile_conv.kde_launches
    got = tile_conv.tile_kde_sums_cuda(lay, radius)
    again = tile_conv.tile_kde_sums_cuda(lay, radius)
    want = tile_conv.tile_kde_sums_reference(lay, radius)
    torch.cuda.synchronize()
    assert tile_conv.kde_launches == before + 2 and torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)
    # the same real steps without the budget's inert padding: the same bits
    real, inert = tile_conv.real_steps(lay.steps)
    tight = tile_conv.self_layout(pts, mask, radius, max_pairs=1 << 30, chunk=chunk,
                                  max_steps=int(real.max()))
    assert int(tight.overflow.max()) == 0
    assert torch.equal(tile_conv.tile_kde_sums_cuda(tight, radius), got)
    if chunk == 1:
        assert int(inert.min()) > 100
    dens = tile_conv.tile_kde(pts, mask, radius, max_pairs=1 << 30)
    torch.testing.assert_close(dens, density_kernel.kde_density_cuda(pts, mask, radius),
                               rtol=1e-4, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("N,radius", [(700, 0.1), (3000, 0.05)])
def test_cover_kernel_is_bit_equal_to_plain_and_sampler_to_dense(cuda, N, radius):
    pts, mask = cloud(11, N=N, masked=40, device=cuda)
    sweep = tile_conv.make_cover_sweep(pts, mask, radius, max_pairs=1 << 30)
    g = torch.Generator().manual_seed(12)
    flags = sweep.valid & (torch.rand(sweep.valid.shape, generator=g) < 0.3).to(cuda)
    before = tile_conv.cover_launches
    got = tile_conv.cover_counts_cuda(sweep.layout, flags, radius)
    want = tile_conv.cover_counts_reference(sweep.layout, flags, radius)
    torch.cuda.synchronize()
    assert tile_conv.cover_launches == before + 1
    assert torch.equal(got, want)
    sel = poisson_disk(pts, mask, radius, N, tile_pairs=1 << 30).selected
    cids, colors = sweep_cells(pts, radius)
    dense = poisson_kernel.poisson_sweep_reference(pts, mask, cids, colors, radius) & mask
    assert torch.equal(sel, dense)


def _sampler_sweep(pts, mask, radius):
    """The tile sampler's cover sweep of ``pts`` and, per sorted row, its cell
    id, colour and whether it starts its cell's run (the sampler's order)."""
    from mccnn_tpu_torch.core import sampling
    from mccnn_tpu_torch.core.grid import cell_color27, linear_cell_ids

    coords, res = sampling._sampler_grid(pts, radius)
    order = sampling._cell_hilbert_order(coords, mask, res)
    sweep = tile_conv.make_cover_sweep(pts, mask, radius, max_pairs=1 << 30, order=order)
    B, N = mask.shape
    pad = sweep.valid.shape[1] - N

    def sort1(x):
        s = torch.gather(x, 1, order)
        return torch.cat([s, s.new_full((B, pad), -1)], dim=1)

    s_cids, s_colors = sort1(linear_cell_ids(coords, res)), sort1(cell_color27(coords))
    first = torch.cat([torch.ones_like(s_cids[:, :1], dtype=torch.bool),
                       s_cids[:, 1:] != s_cids[:, :-1]], dim=1)
    return sweep, s_colors, first


@pytest.mark.cuda
@pytest.mark.parametrize("minor", ["8", "32", "128"])
@pytest.mark.parametrize("kind", ["sampler", "none", "all", "invalid"])
def test_cover_kernel_flag_patterns_are_bit_equal_to_plain(cuda, monkeypatch, minor, kind):
    """K8 bit for bit against its plain version and on repeat: a colour's
    sampler-like flags (the first point of each of its cells), no flag, every
    row flagged (invalid rows too), and flags on invalid rows only."""
    monkeypatch.setattr(tile_conv, "_MINOR", minor)
    pts, mask = clustered_cloud(13, 2, 3000, 300, cuda)
    sweep, s_colors, first = _sampler_sweep(pts, mask, 0.05)
    flag_sets = {"sampler": [first & (s_colors == c) & sweep.valid for c in (0, 13, 26)],
                 "none": [torch.zeros_like(sweep.valid)],
                 "all": [torch.ones_like(sweep.valid)],
                 "invalid": [~sweep.valid]}[kind]
    for flags in flag_sets:
        got = tile_conv.cover_counts_cuda(sweep.layout, flags, 0.05)
        again = tile_conv.cover_counts_cuda(sweep.layout, flags, 0.05)
        want = tile_conv.cover_counts_reference(sweep.layout, flags, 0.05)
        torch.cuda.synchronize()
        assert sweep.layout.steps.Tm == int(minor)
        assert torch.equal(got, want) and torch.equal(got, again)
        if kind in ("none", "invalid"):
            assert int(got.abs().sum()) == 0


# ------------------------------------------------------------ the tile switches' kernels

TILE_NAMES = ("d_wf", "dw1", "db1", "dw2", "db2")


def _tile_variant_case(device, c_in, c_out, mean, max_steps=None):
    """A layout with both lists, its sorted weighted features, the forward's
    count and a seeded dout: the inputs of every tile forward and backward."""
    params, smp, qmask, src, smask, feats, pdf = _tile_conv_case(device, c_in, c_out)
    lay = tile_conv.conv_layout(smp, qmask, src, smask, 0.2, max_pairs=1 << 30,
                                max_steps=max_steps, backward=True)
    wf = tile_conv._sorted_weighted_features(lay, feats, pdf)
    out, cnt = tile_conv.tile_conv_sorted_reference(params, lay, wf, 0.2, c_out=c_out,
                                                    mean_normalize=mean)
    g = torch.Generator().manual_seed(13)
    dout = torch.randn(out.shape, generator=g).to(device)
    return params, lay, wf, cnt, dout


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,mean,minor", [(1, 16, False, "32"), (8, None, True, "32"),
                                                   (40, None, False, "8"), (3, 5, True, "64"),
                                                   (256, None, False, "8"), (1, 64, True, "128"),
                                                   (384, None, True, "32"), (64, None, True, "128"),
                                                   (1024, None, False, "16")])
def test_packed_tile_kernels_are_bit_equal_to_k5_and_k6(cuda, monkeypatch, c_in, c_out, mean,
                                                        minor):
    monkeypatch.setattr(tile_conv, "_MINOR", minor)
    params, lay, wf, cnt, dout = _tile_variant_case(cuda, c_in, c_out, mean)
    kw = dict(c_out=c_out, mean_normalize=mean)
    counters = lambda: (tile_conv.packed_launches, tile_conv.packed_backward_launches)  # noqa: E731
    before = counters()
    got = tile_conv.tile_conv_sorted_packed_cuda(params, lay, wf, 0.2, **kw)
    want = tile_conv.tile_conv_sorted_cuda(params, lay, wf, 0.2, **kw)
    bargs = (params, lay, wf, 0.2, cnt, dout)
    gotb = tile_conv.tile_conv_backward_sorted_packed_cuda(*bargs, **kw)
    wantb = tile_conv.tile_conv_backward_sorted_cuda(*bargs, **kw)
    torch.cuda.synchronize()
    assert counters() == (before[0] + 1, before[1] + 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for name, a, w in zip(TILE_NAMES, gotb, wantb):
        assert torch.equal(a, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,mean,max_steps,minor",
                         [(8, None, False, None, "32"), (1, 16, False, None, "32"),
                          (40, None, True, None, "16"), (8, None, False, 2, "32"),
                          (3, 5, True, 2, "128")])
def test_tile_v1_backward_kernel_matches_plain_and_k6_and_repeats_bitwise(
        cuda, monkeypatch, c_in, c_out, mean, max_steps, minor):
    monkeypatch.setattr(tile_conv, "_MINOR", minor)
    params, lay, wf, cnt, dout = _tile_variant_case(cuda, c_in, c_out, mean, max_steps)
    args = (params, lay, wf, 0.2, cnt, dout)
    kw = dict(c_out=c_out, mean_normalize=mean)
    before = tile_conv.backward_v1_launches
    got = tile_conv.tile_conv_backward_v1_sorted_cuda(*args, **kw)
    again = tile_conv.tile_conv_backward_v1_sorted_cuda(*args, **kw)
    want = tile_conv.tile_conv_backward_v1_sorted_reference(*args, **kw)
    k6 = tile_conv.tile_conv_backward_sorted_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert tile_conv.backward_v1_launches == before + 2
    for name, a, a2, w, w6 in zip(TILE_NAMES, got, again, want, k6):
        assert a.shape == w.shape, name
        assert torch.equal(a, a2), name  # one writer per output, fixed-order reductions
        # fp32 sums over the backward list's pairs, h and channels in other
        # orders; every side rounds pre_h as mc_preact does (the same ReLU steps)
        for ref in (w, w6):
            scale = float(ref.abs().max())
            assert scale > 0, name
            torch.testing.assert_close(a, ref, rtol=0.0, atol=1e-5 * scale, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("minor", ["8", "16", "64", "128"])
def test_tile_kernels_at_every_minor_match_plain(cuda, monkeypatch, minor):
    monkeypatch.setattr(tile_conv, "_MINOR", minor)
    params, lay, wf, cnt, dout = _tile_variant_case(cuda, 8, None, False)
    assert lay.steps.Tm == int(minor) and lay.steps.j_ids.shape[1] == 1024 // int(minor)
    got = tile_conv.tile_conv_sorted_cuda(params, lay, wf, 0.2)
    want = tile_conv.tile_conv_sorted_reference(params, lay, wf, 0.2)
    gotb = tile_conv.tile_conv_backward_sorted_cuda(params, lay, wf, 0.2, cnt, dout)
    wantb = tile_conv.tile_conv_backward_sorted_reference(params, lay, wf, 0.2, cnt, dout)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4 * float(want[0].abs().max()))
    for name, a, w in zip(TILE_NAMES, gotb, wantb):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()), msg=name)
    pts, mask = cloud(11, N=1500, masked=40, device=cuda)
    sweep = tile_conv.make_cover_sweep(pts, mask, 0.1, max_pairs=1 << 30)
    g = torch.Generator().manual_seed(12)
    flags = sweep.valid & (torch.rand(sweep.valid.shape, generator=g) < 0.3).to(cuda)
    kde = tile_conv.tile_kde_sums_cuda(sweep.layout, 0.1)
    cover = tile_conv.cover_counts_cuda(sweep.layout, flags, 0.1)
    torch.cuda.synchronize()
    assert sweep.layout.steps.Tm == int(minor)
    torch.testing.assert_close(kde, tile_conv.tile_kde_sums_reference(sweep.layout, 0.1),
                               rtol=1e-4, atol=0.0)
    assert torch.equal(cover, tile_conv.cover_counts_reference(sweep.layout, flags, 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("pack,v1,moved", [(True, False, ("K5p", "K6p")),
                                           (False, True, ("K5", "K6v1")),
                                           (True, True, ("K5", "K6v1"))])
def test_tile_switches_launch_their_kernels(cuda, monkeypatch, pack, v1, moved):
    monkeypatch.setattr(tile_conv, "_PACK", pack)
    monkeypatch.setattr(tile_conv, "_BWD_V1", v1)
    case = _tile_conv_case(cuda, 6, 4)
    names = {"K5": "launches", "K6": "backward_launches", "K5p": "packed_launches",
             "K6p": "packed_backward_launches", "K6v1": "backward_v1_launches"}
    before = {k: getattr(tile_conv, a) for k, a in names.items()}
    params = type(case[0])(*(t.detach().requires_grad_() for t in case[0]))
    out = tile_conv.tile_mc_conv(params, *case[1:], 0.2, max_pairs=1 << 30, c_out=4)
    out.square().sum().backward()
    torch.cuda.synchronize()
    delta = {k: getattr(tile_conv, a) - before[k] for k, a in names.items()}
    assert delta == {k: int(k in moved) for k in names}


def test_tile_variant_wrappers_refuse_cpu_tensors():
    pts, mask = cloud(6, N=160)
    params = init_mcconv_params(torch.Generator().manual_seed(0), 2, None)
    lay = tile_conv.conv_layout(pts, mask, pts, mask, 0.2, max_pairs=1 << 30, backward=True)
    wf = tile_conv._sorted_weighted_features(lay, torch.ones((2, 160, 2)), torch.ones((2, 160)))
    cnt, dout = torch.ones((2, 256)), torch.ones((2, 256, 2))
    calls = [
        lambda: tile_conv.tile_conv_sorted_packed_cuda(params, lay, wf, 0.2),
        lambda: tile_conv.tile_conv_backward_sorted_packed_cuda(params, lay, wf, 0.2, cnt, dout),
        lambda: tile_conv.tile_conv_backward_v1_sorted_cuda(params, lay, wf, 0.2, cnt, dout),
    ]
    counters = lambda: (tile_conv.packed_launches, tile_conv.packed_backward_launches,  # noqa: E731
                        tile_conv.backward_v1_launches)
    before = counters()
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert counters() == before


# ------------------------------------------------------------ the roofline instruments


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,mean", [c[1:4] for c in V1_CASES if c[4] is None])
def test_planes_kernel_matches_plain_and_k1_and_repeats_bitwise(cuda, c_in, c_out, mean):
    params, smp, qmask, src, smask, feats, pdf, _ = _k2_inputs(cuda, c_in, c_out)
    wf = dense_conv._weighted_features(feats, pdf, smask)
    fargs = (params, smp, qmask, src, smask, wf, 0.3, c_out, mean)
    before = dense_conv.launches_planes
    out, cnt, _ = dense_conv.dense_mc_conv_planes_cuda(*fargs)
    again, _, _ = dense_conv.dense_mc_conv_planes_cuda(*fargs)
    want, wcnt, _ = dense_conv._forward_planes_reference(*fargs)
    k1, _, _ = dense_conv._forward_cuda(*fargs)
    torch.cuda.synchronize()
    assert dense_conv.launches_planes == before + 2
    assert torch.equal(out, again) and torch.equal(cnt, wcnt)  # no atomics, the same d2
    scale = float(want.abs().max())
    # the tensor cores sum cw, -sw and b1 in fp32 (the plain version rounds
    # twice); K1 forms pre_h in the offset form; sums in other orders
    for ref in (want, k1):
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4 * scale)


# (name, c_in, c_out, mean, geometry) of K1p's list cases, on _v1_inputs:
# "overflow" puts every source in radius, so the lists overflow their cap
# and resume in rounds; "masked" masks whole groups of 32 samples and
# sources; "global" is the M = 1 site at C = 256, CO = 1024; "stem" the C =
# 1 stem; "passes" C = 160, which takes three channel passes.
PLANES_CASES = [("overflow", 4, 8, False, (1, 1000, 8, GLOBAL_R)),
                ("overflow", 16, None, True, (1, 600, 600, GLOBAL_R)),
                ("masked", 8, 4, False, (2, 300, 200, 0.3)),
                ("global", 256, 1024, False, (3, 40, 1, GLOBAL_R)),
                ("stem", 1, 128, False, (2, 256, 70, 0.3)),
                ("passes", 160, None, False, (2, 300, 200, 0.3))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,c_in,c_out,mean,geometry", PLANES_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in PLANES_CASES])
def test_planes_kernel_on_its_list_cases(cuda, name, c_in, c_out, mean, geometry):
    """K1p where its in-radius lists, their rounds, skipped groups and
    channel passes matter: against its plain version and K1 (K1P_RTOL), its
    count equal to K1's, bit for bit on repeat; only K1p's counter moves."""
    params, smp, qmask, src, smask, wf, _, radius = _v1_inputs(cuda, name, c_in, c_out, geometry)
    fargs = (params, smp, qmask, src, smask, wf, radius, c_out, mean)
    before = (dense_conv.launches, dense_conv.launches_planes)
    out, cnt, G = dense_conv.dense_mc_conv_planes_cuda(*fargs)
    again, _, G2 = dense_conv.dense_mc_conv_planes_cuda(*fargs)
    torch.cuda.synchronize()
    assert (dense_conv.launches, dense_conv.launches_planes) == (before[0], before[1] + 2)
    want, wcnt, wG = dense_conv._forward_planes_reference(*fargs)
    k1, k1cnt, _ = dense_conv._forward_cuda(*fargs)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(G, G2)  # no atomics
    assert torch.equal(cnt, wcnt) and torch.equal(cnt, k1cnt)
    assert torch.isfinite(G).all()
    assert torch.equal(G[~qmask], torch.zeros_like(G[~qmask]))
    scale = float(want.abs().max())
    torch.testing.assert_close(G, wG, rtol=1e-4, atol=1e-4 * float(wG.abs().max()))
    for ref in (want, k1):
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.cuda
def test_planes_route_runs_k1p_forward_and_k2_backward(cuda, monkeypatch):
    monkeypatch.setattr(dense_conv, "_PLANES_MXU", True)
    params, smp, qmask, src, smask, feats, pdf, dout = _k2_inputs(cuda, 8, 4)
    p = [t.detach().requires_grad_() for t in params]
    counters = lambda: (dense_conv.launches, dense_conv.backward_launches,  # noqa: E731
                        dense_conv.launches_planes)
    before = counters()
    out = dense_conv.dense_mc_conv(type(params)(*p), smp, qmask, src, smask, feats, pdf, 0.3,
                                   c_out=4)
    (out * dout).sum().backward()
    torch.cuda.synchronize()
    assert counters() == (before[0], before[1] + 1, before[2] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["noop", "planes", "mm"])
@pytest.mark.parametrize("c_in,c_out,mean,minor", [(1, 16, False, "32"), (8, None, True, "8"),
                                                   (40, None, False, "16"), (3, 5, True, "128"),
                                                   (1, 64, False, "8"), (64, None, True, "128"),
                                                   (384, None, False, "32")])
def test_tile_probe_kernels_match_plain_and_repeat_bitwise(cuda, monkeypatch, probe, c_in, c_out,
                                                           mean, minor):
    monkeypatch.setattr(tile_conv, "_MINOR", minor)
    params, lay, wf, _, _ = _tile_variant_case(cuda, c_in, c_out, mean)
    args = (probe, params, lay, wf, 0.2)
    kw = dict(c_out=c_out, mean_normalize=mean)
    before = tile_conv.launches_probe[probe]
    got = tile_conv.tile_conv_probe_sorted_cuda(*args, **kw)
    again = tile_conv.tile_conv_probe_sorted_cuda(*args, **kw)
    packed = tile_conv.tile_conv_probe_sorted_packed_cuda(*args, **kw)
    want = tile_conv.tile_conv_probe_sorted_reference(*args, **kw)
    torch.cuda.synchronize()
    assert tile_conv.launches_probe[probe] == before + 3
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], want[1])
    assert torch.equal(packed[0], got[0]) and torch.equal(packed[1], got[1])
    if probe == "noop":
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        return
    scale = float(want[0].abs().max())
    assert scale > 0
    # fp32 sums over the step list's pairs (and h, channels) in other orders
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,mean,minor", [(8, None, False, "32"), (1, 16, False, "64"),
                                                   (3, 5, True, "8"), (256, None, True, "128"),
                                                   (1, 64, False, "32")])
def test_tile_bwd_noop_kernels_give_zero_gradients(cuda, monkeypatch, c_in, c_out, mean, minor):
    monkeypatch.setattr(tile_conv, "_MINOR", minor)
    params, lay, wf, cnt, dout = _tile_variant_case(cuda, c_in, c_out, mean)
    args = (params, lay, wf, 0.2, cnt, dout)
    kw = dict(c_out=c_out, mean_normalize=mean)
    before = tile_conv.backward_launches_probe
    got = tile_conv.tile_conv_backward_noop_sorted_cuda(*args, **kw)
    packed = tile_conv.tile_conv_backward_noop_sorted_packed_cuda(*args, **kw)
    want = tile_conv.tile_conv_backward_noop_sorted_reference(*args, **kw)
    k6 = tile_conv.tile_conv_backward_sorted_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert tile_conv.backward_launches_probe == before + 2
    for name, a, b, w, r in zip(TILE_NAMES, got, packed, want, k6):
        assert a.shape == w.shape == r.shape, name
        assert torch.equal(a, w) and torch.equal(b, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("probe,moved", [("mm", ("probe", "K6")), ("bwd_noop", ("K5", "bwd"))])
def test_tile_probes_route_through_tile_mc_conv(cuda, monkeypatch, probe, moved):
    monkeypatch.setattr(tile_conv, "_PROBE", probe)
    case = _tile_conv_case(cuda, 6, 4)
    counts = lambda: {"K5": tile_conv.launches, "K6": tile_conv.backward_launches,  # noqa: E731
                      "probe": tile_conv.launches_probe["mm"],
                      "bwd": tile_conv.backward_launches_probe}
    before = counts()
    params = type(case[0])(*(t.detach().requires_grad_() for t in case[0]))
    out = tile_conv.tile_mc_conv(params, *case[1:], 0.2, max_pairs=1 << 30, c_out=4)
    out.square().sum().backward()
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in counts().items()}
    assert delta == {k: int(k in moved) for k in before}


def _t1_inputs(device, N=300, C=40, seed=5):
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand((2, N, 3), generator=g)
    feats = torch.randn((2, N, C), generator=g)
    w1, b1 = torch.randn((8, 8), generator=g), torch.randn((8,), generator=g)
    w2, b2 = torch.randn((8, C), generator=g), torch.randn((C,), generator=g)
    return [t.to(device) for t in (pts, feats, w1, b1, w2, b2)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", dense_probe.VARIANTS)
def test_dense_probe_kernels_match_plain_and_repeat_bitwise(cuda, variant):
    args = (*_t1_inputs(cuda), 0.2)
    before = dense_probe.launches[variant]
    got = dense_probe.dense_probe_cuda(variant, *args)
    again = dense_probe.dense_probe_cuda(variant, *args)
    want = dense_probe.dense_probe_reference(variant, *args)
    torch.cuda.synchronize()
    assert dense_probe.launches[variant] == before + 2
    assert torch.equal(got, again)
    # the same planes (explicit roundings, the same bf16 casts); the products
    # with the bf16 features summed in fp32 in other orders
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["noop", "mm_only", "mm_big"])
@pytest.mark.parametrize("N,C", [(1000, 40), (300, 1), (300, 24), (300, 1024), (1500, 40)])
def test_mm_big_kernel_at_edge_shapes(cuda, variant, N, C):
    """T1's staged-schedule kernels (noop, mm_only on the CUDA cores, mm_big's
    tensor-core GEMM tiles) where N or C is not a multiple of the tile (C = 1
    and C = 24 take the plain loads, N = 1000 a ragged last source step and
    sample tile, N = 1500 the ring of stages past 1024 sources): against the
    plain version within T1_RTOL, bit for bit on repeat, two launches
    counted."""
    args = (*_t1_inputs(cuda, N=N, C=C), 0.2)
    before = dense_probe.launches[variant]
    got = dense_probe.dense_probe_cuda(variant, *args)
    again = dense_probe.dense_probe_cuda(variant, *args)
    want = dense_probe.dense_probe_reference(variant, *args)
    torch.cuda.synchronize()
    assert dense_probe.launches[variant] == before + 2
    assert torch.equal(got, again)
    # bf16 products are exact in fp32; the sums over sources in other orders
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
def test_staged_bytes_of_the_t1_schedule(cuda):
    """The bytes T1's staged schedule copies a call, as the library counts
    them: 128 x 64 output tiles, each copying its 128-source steps (a 128 x
    64 bf16 fz tile and 128 x values) once where they are resident (N <=
    1024), (H+1) times in the ring past it."""
    step = 128 * 64 * 2 + 128 * 4
    assert dense_probe.staged_bytes(8, 1024, 128) == 8 * 8 * 2 * 8 * step  # the tool's shape
    assert dense_probe.staged_bytes(8, 1500, 128) == 8 * 12 * 2 * 9 * 12 * step
    assert dense_probe.staged_bytes(2, 300, 24) == 2 * 3 * 1 * 3 * step


def test_roofline_wrappers_refuse_cpu_tensors():
    pts, mask = cloud(6, N=160)
    params = init_mcconv_params(torch.Generator().manual_seed(0), 2, None)
    lay = tile_conv.conv_layout(pts, mask, pts, mask, 0.2, max_pairs=1 << 30, backward=True)
    wf = tile_conv._sorted_weighted_features(lay, torch.ones((2, 160, 2)), torch.ones((2, 160)))
    cnt, dout = torch.ones((2, 256)), torch.ones((2, 256, 2))
    calls = [
        lambda: dense_conv.dense_mc_conv_planes_cuda(params, pts, mask, pts, mask, wf[:, :160],
                                                     0.2),
        lambda: tile_conv.tile_conv_probe_sorted_cuda("mm", params, lay, wf, 0.2),
        lambda: tile_conv.tile_conv_probe_sorted_packed_cuda("planes", params, lay, wf, 0.2),
        lambda: tile_conv.tile_conv_backward_noop_sorted_cuda(params, lay, wf, 0.2, cnt, dout),
        lambda: tile_conv.tile_conv_backward_noop_sorted_packed_cuda(params, lay, wf, 0.2, cnt,
                                                                     dout),
        lambda: dense_probe.dense_probe_cuda("mm_only", *_t1_inputs("cpu"), 0.2),
    ]
    counters = lambda: (dense_conv.launches_planes, dict(tile_conv.launches_probe),  # noqa: E731
                        tile_conv.backward_launches_probe, dict(dense_probe.launches))
    before = counters()
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert counters() == before
