"""Kernel layer: backend dispatch (``dispatch.py``) and the CUDA kernels (``cuda/``)."""
