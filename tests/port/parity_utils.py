"""Helpers shared by the port's parity tests."""

import numpy as np

SQRT3 = 3.0**0.5


def boundary_free(pts, mask, radii, tol=1e-6):
    """True when no valid pair has |d^2 - r^2| < tol for any radius (float64),
    and no nonzero coordinate sits within 10 * tol of a sampler cell face (0
    divides exactly everywhere).

    Exact port-vs-JAX equality of in-radius tests is only claimed on such
    inputs: the two sides round d2 differently near the boundary."""
    p = pts.astype(np.float64)
    for b in range(p.shape[0]):
        q = p[b][mask[b]]
        d2 = ((q[:, None, :] - q[None, :, :]) ** 2).sum(-1)
        for r in radii:
            if np.abs(d2 - r * r).min() < tol:
                return False
            x = q[q != 0.0] / (r / SQRT3)
            if np.abs(x - np.round(x)).min() < tol * 10:
                return False
    return True
