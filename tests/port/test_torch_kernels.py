"""Parity of each kernel module of mccnn_tpu_torch against the JAX package, on the CPU.

On a CPU tensor every kernel wrapper runs its plain PyTorch version, so these
tests hold the plain K4 (KDE), K3 (Poisson sweep) and K1 (dense MC conv)
against the JAX reference: its jnp path and its Pallas kernel in interpret
mode. The CUDA kernels are held against the same plain versions on the card
(tests/port/test_torch_cuda.py and chip_smoke.py). Inputs come from a seeded
numpy generator and include masked tail points.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.core import grid as jgrid
from mccnn_tpu.core import mc_conv, radius_neighbors
from mccnn_tpu.core.mcconv import MCConvParams as JParams
from mccnn_tpu.core.mcconv import init_mcconv_params as j_init_mcconv_params
from mccnn_tpu.core.pdf import kde_density as j_kde_density
from mccnn_tpu.core.sampling import _SQRT3, _poisson_dense
from mccnn_tpu.core.sampling import poisson_disk as j_poisson_disk
from mccnn_tpu.ops.pallas import dense_mc_conv as j_dense_mc_conv
from mccnn_tpu.ops.pallas.density_kernel import kde_density_pallas
from mccnn_tpu.ops.pallas.poisson_kernel import poisson_sweep_pallas
from mccnn_tpu_torch.core.mcconv import MCConvParams, init_mcconv_params
from mccnn_tpu_torch.core.pdf import kde_density
from mccnn_tpu_torch.core.sampling import poisson_disk, sweep_cells
from mccnn_tpu_torch.ops.cuda.dense_conv import dense_mc_conv_reference
from mccnn_tpu_torch.ops.cuda.density_kernel import kde_density_reference
from mccnn_tpu_torch.ops.cuda.poisson_kernel import poisson_sweep_reference
from parity_utils import boundary_free


def cloud(seed, B=2, N=200, masked=17):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, size=(B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), bool)
    if masked:
        mask[:, -masked:] = False
    return pts, mask


def test_boundary_free_detects_a_boundary_pair():
    pts = np.array([[[0.1, 0.1, 0.1], [0.3, 0.1, 0.1]]], np.float32)
    assert not boundary_free(pts, np.ones((1, 2), bool), [0.2])
    assert boundary_free(pts, np.ones((1, 2), bool), [0.3])


# --------------------------------------------------------------------- K4 KDE

KDE_CASES = [(0, 200, 17, 0.25), (1, 256, 5, 0.2), (2, 40, 3, math.sqrt(3.0) + 0.1)]


def kde_float64(pts, mask, radius, kde_window=0.25):
    p = pts.astype(np.float64)
    h = kde_window * radius
    d2 = ((p[:, :, None] - p[:, None]) ** 2).sum(-1)
    kern = np.where((d2 <= radius * radius) & mask[:, None, :], np.exp(-0.5 * d2 / (h * h)), 0.0)
    return np.where(mask, kern.sum(-1) / (h**3 * (2 * np.pi) ** 1.5), 1.0)


@pytest.mark.parametrize("seed,N,masked,radius", KDE_CASES)
def test_kde_plain_matches_jax_dense(seed, N, masked, radius):
    pts, mask = cloud(seed, N=N, masked=masked)
    want = np.asarray(j_kde_density(jnp.asarray(pts), jnp.asarray(mask), radius))
    got = kde_density(torch.from_numpy(pts), torch.from_numpy(mask), radius).numpy()
    # rtol 1e-4: both sides expand d2 = |p|^2 + |q|^2 - 2 p.q in fp32, whose
    # rounding (a few ulp of |p|^2 ~ 1, i.e. ~2.4e-7; the JAX path's
    # self-pair d2 reaches 4.8e-7 where the port's is exactly 0) moves exp's
    # argument by 0.5 * delta / h^2: up to ~6e-5 relative at h = 0.05.
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # Against the float64 truth the port is the closer of the two.
    truth = kde_float64(pts, mask, radius)
    np.testing.assert_allclose(got, truth, rtol=5e-5)
    assert np.abs(got / truth - 1).max() <= np.abs(want / truth - 1).max()
    assert np.all(got[~mask] == 1.0)


@pytest.mark.parametrize("seed,N,masked,radius", KDE_CASES[:2])
def test_kde_plain_matches_jax_pallas_interpret(seed, N, masked, radius):
    pts, mask = cloud(seed, N=N, masked=masked)
    want = np.asarray(
        kde_density_pallas(jnp.asarray(pts), jnp.asarray(mask), radius, interpret=True)
    )
    got = kde_density_reference(torch.from_numpy(pts), torch.from_numpy(mask), radius).numpy()
    # the reference's own kernel-vs-dense tolerance (test_fused_aux_kernels.py:26)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ K3 Poisson sweep

POISSON_CASES = [(3, 200, 17, 0.18), (4, 256, 0, 0.1), (6, 256, 30, 0.4)]


@pytest.mark.parametrize("seed,N,masked,radius", POISSON_CASES)
def test_poisson_plain_matches_jax_exactly(seed, N, masked, radius):
    pts, mask = cloud(seed, N=N, masked=masked)
    # Exact equality is only meaningful away from the d2 = r2 boundary.
    assert boundary_free(pts, mask, [radius])
    jp, jm = jnp.asarray(pts), jnp.asarray(mask)
    res = jgrid.grid_res_for_radius(radius, cell_scale=1.0 / _SQRT3)
    coords = jgrid.cell_coords(jp, float(radius) / _SQRT3, res)
    jcids, jcolors = jgrid.linear_cell_ids(coords, res), jgrid.cell_color27(coords)
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    cids, colors = sweep_cells(tp, radius)
    np.testing.assert_array_equal(cids.numpy(), np.asarray(jcids))
    np.testing.assert_array_equal(colors.numpy(), np.asarray(jcolors))

    got = poisson_sweep_reference(tp, tm, cids, colors, radius).numpy()
    want_dense = np.asarray(_poisson_dense(jp, jm, jcids, jcolors, radius) & jm)
    want_pallas = np.asarray(
        poisson_sweep_pallas(jp, jm, jcids, jcolors, radius, interpret=True)
    )
    np.testing.assert_array_equal(got, want_dense)
    np.testing.assert_array_equal(got, want_pallas)

    cap = 128
    ss = poisson_disk(tp, tm, radius, cap)
    jss = j_poisson_disk(jp, jm, radius, cap)
    np.testing.assert_array_equal(ss.selected.numpy(), np.asarray(jss.selected))
    np.testing.assert_array_equal(ss.mask.numpy(), np.asarray(jss.mask))
    np.testing.assert_array_equal(ss.idx.numpy(), np.asarray(jss.idx))

    # The sampler's invariants hold whatever the boundary.
    for b in range(pts.shape[0]):
        sel = pts[b][got[b]]
        d = np.linalg.norm(sel[:, None] - sel[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        assert d.min() >= radius - 1e-6
        cover = np.linalg.norm(pts[b][mask[b]][:, None] - sel[None, :], axis=-1).min(-1)
        assert cover.max() <= radius + 1e-6
        assert not got[b][~mask[b]].any()


# ---------------------------------------------------------------- K1 MC conv

CONV_CASES = {
    "depthwise": (None, False),
    "full": (4, False),
    "depthwise_mean": (None, True),
    "full_mean": (4, True),
}


def conv_inputs(seed, c_out, B=2, N=80, M=50, C=8, radius=0.3):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 1, size=(B, N, 3)).astype(np.float32)
    smp = rng.uniform(0, 1, size=(B, M, 3)).astype(np.float32)
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    smask = np.ones((B, N), bool)
    smask[:, -7:] = False
    qmask = np.ones((B, M), bool)
    qmask[:, -5:] = False
    pdf = rng.uniform(0.5, 2.0, size=(B, N)).astype(np.float32)
    out_dim = C if c_out is None else C * c_out
    params = [
        rng.normal(size=(3, 8)).astype(np.float32) * (2.0 / 3.0) ** 0.5,
        rng.normal(size=(8,)).astype(np.float32) * 0.1,
        rng.normal(size=(8, out_dim)).astype(np.float32) * 0.5,
        rng.normal(size=(out_dim,)).astype(np.float32) * 0.1,
    ]
    return (src, smp, feats, smask, qmask, pdf, radius), params


def port_conv(inputs, params, c_out, mean):
    src, smp, feats, smask, qmask, pdf, radius = map(
        lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x, inputs
    )
    out, cnt = dense_mc_conv_reference(
        MCConvParams(*map(torch.from_numpy, params)), smp, qmask, src, smask, feats,
        pdf, radius, c_out=c_out, mean_normalize=mean, with_count=True,
    )
    return out.numpy(), cnt.numpy()


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_plain_matches_jax_mc_conv(case):
    c_out, mean = CONV_CASES[case]
    inputs, params = conv_inputs(6, c_out)
    src, smp, feats, smask, qmask, pdf, radius = inputs
    assert boundary_free(np.concatenate([src, smp], 1),
                         np.concatenate([smask, qmask], 1), [radius])
    jsrc, jsmp, jfeats, jsmask, jqmask, jpdf = map(jnp.asarray, inputs[:-1])
    # k = N makes the neighbour-list conv lossless (test_dense_conv.py:24-27)
    nbh = radius_neighbors(jsmp, jqmask, jsrc, jsmask, radius, src.shape[1])
    want = mc_conv(JParams(*map(jnp.asarray, params)), jsmp, nbh, jsrc, jfeats, jpdf,
                   c_out=c_out, mean_normalize=mean)
    want = np.asarray(jnp.where(jqmask[..., None], want, 0.0))
    got, cnt = port_conv(inputs, params, c_out, mean)
    # rtol 1e-4 / atol 1e-4 * max: both fp32, summed in other orders.
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(cnt, np.asarray(nbh.mask.sum(-1)))


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_plain_matches_jax_dense_kernel_interpret(case):
    c_out, mean = CONV_CASES[case]
    inputs, params = conv_inputs(7, c_out)
    src, smp, feats, smask, qmask, pdf, radius = inputs
    want = np.asarray(j_dense_mc_conv(
        JParams(*map(jnp.asarray, params)), jnp.asarray(smp), jnp.asarray(qmask),
        jnp.asarray(src), jnp.asarray(smask), jnp.asarray(feats), jnp.asarray(pdf),
        radius, c_out=c_out, mean_normalize=mean, interpret=True,
    ))
    got, _ = port_conv(inputs, params, c_out, mean)
    # rtol 2e-2: the TPU kernel runs features and planes through bf16
    # (the reference's own tolerance, test_dense_conv.py:43).
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


def test_conv_global_radius_sees_every_valid_source():
    inputs, params = conv_inputs(8, 4, M=8)
    inputs = inputs[:-1] + (math.sqrt(3.0) + 0.1,)
    _, cnt = port_conv(inputs, params, 4, False)
    smask, qmask = inputs[3], inputs[4]
    want = np.where(qmask, smask.sum(-1, keepdims=True), 0)
    np.testing.assert_array_equal(cnt, want)


def test_conv_masked_samples_are_zero():
    inputs, params = conv_inputs(9, None)
    got, cnt = port_conv(inputs, params, None, True)
    assert np.all(got[~inputs[4]] == 0.0) and np.all(cnt[~inputs[4]] == 0.0)


def test_init_mcconv_params_is_seeded():
    a = init_mcconv_params(torch.Generator().manual_seed(3), 4, 2)
    b = init_mcconv_params(torch.Generator().manual_seed(3), 4, 2)
    assert [tuple(t.shape) for t in a] == [(3, 8), (8,), (8, 8), (8,)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    want = [tuple(t.shape) for t in j_init_mcconv_params(jax.random.PRNGKey(0), 4, 2)]
    assert want == [tuple(t.shape) for t in a]
