"""Hand-written CUDA kernels (``csrc/*.cu``) and their plain PyTorch versions.

Module names follow ``mccnn_tpu/ops/pallas/``. Each public function picks by
the device of its tensors: CPU -> the plain ``*_reference`` version, CUDA ->
the kernel (built at first use by ``_build.library()``).
"""

from .dense_conv import dense_mc_conv
from .density_kernel import kde_density_dense
from .mcconv_kernel import bucket_mc_conv
from .poisson_kernel import poisson_sweep
from .tile_conv import make_cover_sweep, tile_kde, tile_mc_conv

__all__ = ["bucket_mc_conv", "dense_mc_conv", "kde_density_dense", "make_cover_sweep",
           "poisson_sweep", "tile_kde", "tile_mc_conv"]
