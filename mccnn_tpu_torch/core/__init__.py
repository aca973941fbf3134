"""Core spatial ops: grid indexing, gathers, KDE pdf, Poisson-disk sampling."""

from .gather import batched_gather, gather_rows, masked_mean
from .grid import (
    cell_color27,
    cell_coords,
    compute_aabb,
    grid_res_for_radius,
    linear_cell_ids,
    normalize_to_unit_cube,
)
from .mcconv import KERNEL_HIDDEN, MCConvParams, init_mcconv_params
from .pdf import kde_density
from .sampling import SampleSet, poisson_disk

__all__ = [
    "KERNEL_HIDDEN",
    "MCConvParams",
    "SampleSet",
    "batched_gather",
    "cell_color27",
    "cell_coords",
    "compute_aabb",
    "gather_rows",
    "grid_res_for_radius",
    "init_mcconv_params",
    "kde_density",
    "linear_cell_ids",
    "masked_mean",
    "normalize_to_unit_cube",
    "poisson_disk",
]
