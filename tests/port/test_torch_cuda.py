"""The CUDA kernels against their plain versions, and the device routing.

Tests marked ``cuda`` need an NVIDIA GPU and ``nvcc``: they build the kernels
and skip, with a reason, where there is no CUDA device. Run them on the card
with ``python -m pytest tests/port -m cuda``. The unmarked tests check, on the
CPU, that a kernel wrapper refuses what it cannot launch and that unported
sites raise instead of falling back.
"""

import math

import numpy as np
import pytest
import torch

from mccnn_tpu_torch.core.mcconv import init_mcconv_params
from mccnn_tpu_torch.core.pdf import kde_density
from mccnn_tpu_torch.core.sampling import poisson_disk, sweep_cells
from mccnn_tpu_torch.ops.cuda import dense_conv, density_kernel, poisson_kernel
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


@pytest.mark.cuda
@pytest.mark.parametrize("N,radius", [(256, 0.1), (1024, 0.1), (300, 0.4)])
def test_poisson_kernel_is_bit_equal_to_plain(cuda, N, radius):
    pts, mask = cloud(1, N=N, device=cuda)
    cids, colors = sweep_cells(pts, radius)
    got = poisson_kernel.poisson_sweep_cuda(pts, mask, cids, colors, radius)
    want = poisson_kernel.poisson_sweep_reference(pts, mask, cids, colors, radius)
    assert torch.equal(got, want)


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


def test_unported_sites_raise():
    with pytest.raises(NotImplementedError, match="bucket"):
        pick_backend(4096, 0.1, 128, 128, device=torch.device("cuda"))
    assert not dense_fits(4096, 128, 128)
    assert pick_backend(4096, 0.1, 128, 128, device=torch.device("cpu")) == "dense"
    for site in [(1024, 1, 128, 496), (496, 128, 256, 40), (40, 256, 1024, 1)]:
        # MCClassS's three sites sit inside the envelope
        assert pick_backend(site[0], 0.2, site[1], site[2], site[3],
                            device=torch.device("cuda")) == "dense"
    big = torch.zeros((1, 8193, 3))
    with pytest.raises(NotImplementedError, match="K-capacity"):
        kde_density(big, torch.ones((1, 8193), dtype=torch.bool), 0.1)
    with pytest.raises(NotImplementedError, match="tile"):
        poisson_disk(big[:, :4097], torch.ones((1, 4097), dtype=torch.bool), 0.1, 64)
