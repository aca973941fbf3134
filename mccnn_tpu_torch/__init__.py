"""mccnn_tpu_torch — the PyTorch + CUDA port of ``mccnn_tpu``.

The package mirrors ``mccnn_tpu`` module for module (``core/``, ``api/``,
``models/``, ``ops/``, ``train/``, ``data/``, ``utils/``, ``serve.py``,
``tasks/``) and imports nothing of it. Plain tensor code is
PyTorch; every Pallas kernel of the reference becomes a hand-written CUDA
kernel under ``csrc/``, built with ``nvcc`` at first use and bound with
``ctypes`` (``ops/cuda/_build.py``). On a CPU tensor each kernel wrapper runs
its plain PyTorch version instead, which is what the parity tests hold
against the JAX package.

It covers MCClassS inference (the serving path) and training
(``tasks/modelnet.py``), and ScanNet segmentation serving: MCSeg on the
z-order tile kernels (``tasks/scannet.py --eval-only``). Importing the
package needs neither ``nvcc`` nor a GPU.
"""

__version__ = "0.1.0"
