"""The Poisson sweep variants of mccnn_tpu_torch (K3v2, K3v3, K3v4 and the
``MCCNN_POISSON_SWEEP`` switch) against the JAX package, on the CPU.

On a CPU tensor ``poisson_sweep`` runs the plain version of the branch it
routes to; each plain version is written in its variant's own formulation
(two 0/1 products a colour step; colour-sorted windows; SB clouds folded
together). They are held, exactly, against the reference's
``poisson_sweep_pallas`` in interpret mode under the same
``MCCNN_POISSON_SWEEP`` (v4 through its ``_call_v4``) and against the
default sweep, at the reference test's shape (``tests/test_sampling.py:160-183``:
B = 2, N = 300, r = 0.12, the second cloud masked from 250), on its
pathological one-cell cloud (``:185-205``, where v3 takes the default sweep),
and at a batch v4 cannot fold. Every input is checked boundary-free (no pair
with |d2 - r2| < 1e-6), so exact equality is meaningful. The routing test
reads ``poisson_kernel.routes``; the kernels themselves are held against
these plain versions on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.core import grid as jgrid
from mccnn_tpu.core.sampling import _SQRT3
from mccnn_tpu.ops.pallas.poisson_kernel import poisson_sweep_pallas
from mccnn_tpu_torch.core.sampling import poisson_disk, sweep_cells
from mccnn_tpu_torch.ops.cuda import poisson_kernel as pk
from parity_utils import boundary_free

RADIUS = 0.12


def reference_cloud(B=2, N=300, masked_from=250, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[B - 1, masked_from:] = False
    return pts, mask


def one_cell_cloud(seed=0):
    """The reference's pathological cloud: 300 points in one cell, one colour
    run longer than the v3 window."""
    rng = np.random.default_rng(seed)
    return (0.30 + 0.0015 * rng.uniform(0, 1, (1, 300, 3))).astype(np.float32), np.ones((1, 300),
                                                                                         bool)


_JAX_SWEEPS = {}


def jax_sweep(pts, mask, variant):
    """The reference's Pallas sweep in interpret mode under ``variant``
    (each input and variant run once per test process)."""
    key = (pts.tobytes(), mask.tobytes(), pts.shape, variant)
    if key not in _JAX_SWEEPS:
        _JAX_SWEEPS[key] = _jax_sweep(pts, mask, variant)
    return _JAX_SWEEPS[key]


def _jax_sweep(pts, mask, variant):
    jp, jm = jnp.asarray(pts), jnp.asarray(mask)
    res = jgrid.grid_res_for_radius(RADIUS, cell_scale=1.0 / _SQRT3)
    coords = jgrid.cell_coords(jp, RADIUS / _SQRT3, res)
    cids, colors = jgrid.linear_cell_ids(coords, res), jgrid.cell_color27(coords)
    with mock.patch.dict(os.environ, {"MCCNN_POISSON_SWEEP": variant}):
        fn = jax.jit(lambda p, m, c, k: poisson_sweep_pallas(p, m, c, k, RADIUS, interpret=True))
        return np.asarray(fn(jp, jm, cids, colors))


def port_sweep(pts, mask, variant):
    """(selection through the switch, the branch it took)."""
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    cids, colors = sweep_cells(tp, RADIUS)
    pk.routes.clear()
    sel = pk.poisson_sweep(tp, tm, cids, colors, RADIUS, variant).numpy()
    (route,) = pk.routes
    return sel, route


CASES = [  # (id, inputs, variant, the branch the reference takes)
    ("v2", reference_cloud, "v2", "v2"),
    ("v3", reference_cloud, "v3", "v3"),
    ("v42", reference_cloud, "v42", "v4"),
    ("v3_one_cell", one_cell_cloud, "v3", "v1"),
    ("v4_unfoldable", reference_cloud, "v4", "v1"),  # B = 2 clouds, SB = 4
    ("v42_unfoldable", lambda: reference_cloud(B=3, N=264, masked_from=200), "v42", "v1"),
]


@pytest.mark.parametrize("inputs,variant,branch", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_variant_matches_reference_exactly(inputs, variant, branch):
    pts, mask = inputs()
    assert boundary_free(pts, mask, [RADIUS])
    got, route = port_sweep(pts, mask, variant)
    assert route == branch
    want = jax_sweep(pts, mask, variant)
    np.testing.assert_array_equal(got, want)
    # and the default sweep, in both packages
    np.testing.assert_array_equal(got, jax_sweep(pts, mask, "v1"))
    assert got.any() and not got[~mask].any()


@pytest.mark.parametrize("sb", [1, 2])
def test_v4_plain_matches_reference_fold(sb):
    """``poisson_sweep_v4_reference`` alone against the reference's
    ``_call_v4`` at SB = 1 and 2 (the reference's test does not run v4)."""
    pts, mask = reference_cloud()
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    cids, colors = sweep_cells(tp, RADIUS)
    got = pk.poisson_sweep_v4_reference(tp, tm, cids, colors, RADIUS, sb=sb).numpy()
    np.testing.assert_array_equal(got, jax_sweep(pts, mask, f"v4{sb}"))


def test_variant_plain_versions_refuse_what_they_cannot_run():
    pts, mask = (torch.from_numpy(a) for a in one_cell_cloud())
    cids, colors = sweep_cells(pts, RADIUS)
    layout = pk.v3_layout(mask, cids, colors)
    assert not bool(layout.fits)
    with pytest.raises(ValueError, match="default sweep"):
        pk.poisson_sweep_v3_reference(pts, mask, cids, colors, RADIUS, layout=layout)
    with pytest.raises(ValueError, match="cannot be folded"):
        pk.poisson_sweep_v4_reference(pts, mask, cids, colors, RADIUS, sb=2)


def test_v3_layout_matches_the_reference_wrapper():
    """Sorted order, aligned starts and ``fits`` as ``poisson_sweep_pallas``
    forms them (``poisson_kernel.py:453-473``), written out in numpy."""
    pts, mask = reference_cloud()
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    cids, colors = sweep_cells(tp, RADIUS)
    layout = pk.v3_layout(tm, cids, colors)
    B, N = mask.shape
    Np = -(-N // 8) * 8
    cid = np.full((B, Np), -1, np.int64)
    cid[:, :N] = np.where(mask, cids.numpy(), -1)
    col = np.full((B, Np), -2, np.int64)
    col[:, :N] = colors.numpy()
    key = np.where(cid >= 0, col * (1 << 24) + cid, 1 << 30)
    np.testing.assert_array_equal(layout.order.numpy(), np.argsort(key, axis=-1, kind="stable"))
    counts = ((col[..., None] == np.arange(27)) & (cid >= 0)[..., None]).sum(1)
    starts_x = np.cumsum(counts, -1) - counts
    aligned = np.minimum(starts_x // 128 * 128, Np - pk.SWEEP_WINDOW)
    np.testing.assert_array_equal(layout.starts.numpy(), aligned)
    assert bool(layout.fits) == bool(np.all(starts_x + counts <= aligned + pk.SWEEP_WINDOW))


def test_routing_counts_each_branch(monkeypatch):
    """Each branch of the reference's routing moves its own counter: v3 at
    Np <= 256 and when a colour run overflows take the default sweep; v4
    without a suffix folds ``MCCNN_POISSON_SB`` clouds, and takes the default
    sweep when B % SB != 0 or SB > 4; any other value takes the v3 branch, as
    in the reference; and the sampler applies the switch only up to N = 1024."""
    pts, mask = reference_cloud()
    assert port_sweep(pts[:, :250], mask[:, :250], "v3")[1] == "v1"  # Np = 256
    assert port_sweep(pts[:, :257], mask[:, :257], "v3")[1] == "v3"  # Np = 264
    assert port_sweep(*one_cell_cloud(), "v3")[1] == "v1"
    assert port_sweep(pts, mask, "v1")[1] == "v1"
    assert port_sweep(pts, mask, "v2")[1] == "v2"
    assert port_sweep(pts, mask, "v5")[1] == "v3"  # any other value takes the v3 branch
    monkeypatch.setattr(pk, "_SB", "2")
    assert port_sweep(pts, mask, "v4")[1] == "v4"
    monkeypatch.setattr(pk, "_SB", "4")
    assert port_sweep(pts, mask, "v4")[1] == "v1"
    assert port_sweep(pts, mask, "v48")[1] == "v1"  # SB > 4
    # the module's switch is the default, and the sampler applies it only
    # where the reference's Pallas sweep runs (N <= 1024)
    monkeypatch.setattr(pk, "_SWEEP", "v2")
    rng = np.random.default_rng(1)
    for n, branch in ((1024, "v2"), (1100, "v1")):
        big = torch.from_numpy(rng.uniform(0, 1, (1, n, 3)).astype(np.float32))
        pk.routes.clear()
        poisson_disk(big, torch.ones((1, n), dtype=torch.bool), 0.2, 64)
        assert dict(pk.routes) == {branch: 1}
