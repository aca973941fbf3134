"""Host-side pieces of mccnn_tpu_torch against the JAX package, on the CPU:
grid bookkeeping, gathers, level capacities and the numpy data copies."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.api.hierarchy import default_level_caps as j_default_level_caps
from mccnn_tpu.core import gather as jgather
from mccnn_tpu.core import grid as jgrid
from mccnn_tpu.data import datasets as jdatasets
from mccnn_tpu.data import synthetic as jsynthetic
from mccnn_tpu_torch.api.hierarchy import build_hierarchy, default_level_caps
from mccnn_tpu_torch.core import gather, grid
from mccnn_tpu_torch.data import datasets, synthetic


def _cloud(seed=0, B=2, N=64):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(B, N, 3)) * [1.0, 3.0, 0.5] + 2.0).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, -9:] = False
    return pts, mask


@pytest.mark.parametrize("scale_inv", [True, False])
def test_normalize_to_unit_cube_matches_jax(scale_inv):
    pts, mask = _cloud()
    mask[0] = False  # a fully-masked cloud gets the degenerate box at the origin
    want = jgrid.normalize_to_unit_cube(jnp.asarray(pts), jnp.asarray(mask), scale_inv=scale_inv)
    got = grid.normalize_to_unit_cube(torch.from_numpy(pts), torch.from_numpy(mask),
                                      scale_inv=scale_inv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("radius", [0.1, 0.4, 2.0])
def test_cell_ids_and_colors_match_jax(radius):
    pts, _ = _cloud(1)
    pts = np.clip(pts / 6.0, -0.1, 1.1).astype(np.float32)  # some outside the cube
    edge = radius / 3.0**0.5
    res = grid.grid_res_for_radius(radius, cell_scale=1 / 3.0**0.5)
    assert res == jgrid.grid_res_for_radius(radius, cell_scale=1 / 3.0**0.5)
    jc = jgrid.cell_coords(jnp.asarray(pts), edge, res)
    tc = grid.cell_coords(torch.from_numpy(pts), edge, res)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(grid.linear_cell_ids(tc, res).numpy(),
                                  np.asarray(jgrid.linear_cell_ids(jc, res)))
    np.testing.assert_array_equal(grid.cell_color27(tc).numpy(),
                                  np.asarray(jgrid.cell_color27(jc)))


def test_pair_d2_is_the_expansion_with_exact_self_pairs():
    pts, _ = _cloud(2)
    t = torch.from_numpy(pts / 6.0)
    d2 = grid.pair_d2(t, t)
    assert torch.all(torch.diagonal(d2, dim1=1, dim2=2) == 0.0)
    p = (pts / 6.0).astype(np.float64)
    want = ((p[:, :, None] - p[:, None]) ** 2).sum(-1)
    np.testing.assert_allclose(d2.numpy(), want, atol=2e-6)
    assert grid.radius_sq(0.1) == float(np.float32(0.1 * 0.1))


def test_gathers_match_jax():
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(2, 10, 4)).astype(np.float32)
    idx = rng.integers(0, 10, size=(2, 6))
    np.testing.assert_array_equal(
        gather.gather_rows(torch.from_numpy(vals), torch.from_numpy(idx)).numpy(),
        np.asarray(jgather.gather_rows(jnp.asarray(vals), jnp.asarray(idx))),
    )
    idx3 = rng.integers(0, 10, size=(2, 6, 3))
    np.testing.assert_array_equal(
        gather.batched_gather(torch.from_numpy(vals), torch.from_numpy(idx3)).numpy(),
        np.asarray(jgather.batched_gather(jnp.asarray(vals), jnp.asarray(idx3))),
    )
    mask = rng.uniform(size=(2, 10)) > 0.3
    np.testing.assert_allclose(
        gather.masked_mean(torch.from_numpy(vals[..., 0]), torch.from_numpy(mask), 1).numpy(),
        np.asarray(jgather.masked_mean(jnp.asarray(vals[..., 0]), jnp.asarray(mask), 1)),
        rtol=1e-6,
    )


@pytest.mark.parametrize("n", [1024, 256, 8])
def test_default_level_caps_match_jax(n):
    assert default_level_caps(n, (0.1, 0.4)) == j_default_level_caps(n, (0.1, 0.4))


def test_fully_masked_cloud_builds_an_empty_hierarchy():
    pts = torch.rand((2, 32, 3), generator=torch.Generator().manual_seed(0))
    mask = torch.ones((2, 32), dtype=torch.bool)
    mask[0] = False
    h = build_hierarchy(pts, mask, (0.2, 0.5), global_level=True)
    caps = default_level_caps(32, (0.2, 0.5))
    assert [tuple(l.mask.shape) for l in h.levels] == [(2, 32), (2, caps[0]), (2, caps[1]), (2, 1)]
    assert not h.levels[1].mask[0].any() and not h.levels[3].mask[0].any()
    assert h.levels[3].mask[1].item() and torch.isfinite(h.levels[3].points).all()


def test_numpy_data_copies_match_the_reference():
    # The port duplicates these host helpers only while mccnn_tpu.data imports
    # JAX; they must stay identical to the originals.
    for kind in synthetic._PRIMS:
        a = synthetic.primitive_cloud(kind, 50, np.random.default_rng(4))
        b = jsynthetic.primitive_cloud(kind, 50, np.random.default_rng(4))
        np.testing.assert_array_equal(a, b)
    a = synthetic.classification_batch(np.random.default_rng(5), 3, 40)
    b = jsynthetic.classification_batch(np.random.default_rng(5), 3, 40)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    cloud = np.random.default_rng(6).normal(size=(30, 3)).astype(np.float32)
    np.testing.assert_array_equal(datasets._normalize_np(cloud), jdatasets._normalize_np(cloud))
    for n in (20, 50):
        a = datasets.pad_points(cloud, n, np.random.default_rng(7))
        b = jdatasets.pad_points(cloud, n, np.random.default_rng(7))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
