"""Builds the package's CUDA kernels and binds them with ``ctypes``.

At first use, ``nvcc`` compiles every ``mccnn_tpu_torch/csrc/*.cu`` for
``sm_90a`` (one ``nvcc`` process per source, all started together) and links
the objects into one shared library with a plain C interface. The library
lands in ``mccnn_tpu_torch/build/`` (git-ignored) under a name that carries a
hash of the sources and flags, so an edited source always rebuilds. It is
loaded with ``ctypes``: every pointer and the stream are ``c_void_p``, every
C entry point returns the ``cudaError_t`` of ``cudaGetLastError()`` after its
launch, and ``check`` raises when that is not 0.

Nothing here runs at import time, and nothing catches a failed build: a
missing ``nvcc`` or a compile error raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C entry points: name -> argument types (restype is always int).
SIGNATURES = {
    "kde_density_launch": [P, P, I, I, F, F, F, P, P],
    "kde_density_culled_launch": [P, P, I, I, F, F, F, P, P, P],
    "kde_culled_scratch_bytes": [I, I],
    "poisson_sweep_launch": [P, P, P, P, I, I, F, P, P],
    "poisson_sweep_probe_launch": [P, P, P, P, I, I, F, P, P, P],
    "poisson_sweep_v2_launch": [P, P, P, P, I, I, F, P, P, P],
    "poisson_sweep_v3_launch": [P, P, P, P, P, P, I, I, I, F, P, P],
    "poisson_sweep_v4_launch": [P, P, P, P, I, I, I, F, P, P],
    "mcconv_pair_launch": [P, P, P, P, P, P, P, I, I, I, I, I, F, F, P, P, P],
    "mcconv_planes_pair_launch": [P, P, P, P, P, P, P, I, I, I, I, I, F, F, P, P, P, P],
    "mcconv_project_splits": [I, I, I],
    "mcconv_project_full_launch": [P, P, P, P, I, I, I, I, P, P, P],
    "mcconv_project_depthwise_launch": [P, P, P, P, I, I, I, P, P],
    "mcconv_bwd_pair_blocks": [I, I, I, I],
    "mcconv_bwd_pair_launch": [P] * 10 + [I] * 6 + [F, F] + [P] * 3,
    "mcconv_bwd_dg_splits": [I, I, I],
    "mcconv_bwd_dg_full_launch": [P, P, P, I, I, I, I, P, P, P],
    "mcconv_bwd_dw2_full_launch": [P, P, I, I, I, I, I, P, P],
    "mcconv_bwd_dw2_depthwise_launch": [P, P, I, I, I, I, I, P, P],
    "mcconv_bwd_reduce_launch": [P, I, I, P, P],
    "mcconv_v1_fwd_launch": [P] * 9 + [I] * 7 + [F, F] + [P] * 3,
    "mcconv_v1_g_launch": [P] * 9 + [I] * 7 + [F, F] + [P] * 3,
    "tile_conv_launch": [P] * 11 + [I] * 10 + [F, F, I, I] + [P] * 3,
    "tile_conv_packed_launch": [P] * 9 + [I] * 9 + [F, F, I, I] + [P] * 3,
    "tile_conv_bwd_blocks": [I] * 5,
    "tile_conv_bwd_launch": [P] * 13 + [I] * 11 + [F, F, I] + [P] * 5,
    "tile_conv_bwd_packed_launch": [P] * 11 + [I] * 11 + [F, F, I] + [P] * 5,
    "tile_conv_bwd_v1_launch": [P] * 13 + [I] * 12 + [F, F, I] + [P] * 4,
    "tile_conv_probe_launch": [I] + [P] * 11 + [I] * 10 + [F, F, I, I] + [P] * 3,
    "tile_conv_packed_probe_launch": [I] + [P] * 9 + [I] * 9 + [F, F, I, I] + [P] * 3,
    "tile_conv_bwd_noop_launch": [P] * 13 + [I] * 11 + [F, F, I] + [P] * 5,
    "tile_conv_bwd_packed_noop_launch": [P] * 11 + [I] * 11 + [F, F, I] + [P] * 5,
    "dense_probe_launch": [I] + [P] * 6 + [I] * 4 + [F, F] + [P] * 2,
    "dense_probe_staged_bytes": [I] * 4,
    "tile_kde_launch": [P, P, P, P, I, I, I, I, I, I, F, F, P, P],
    "tile_cover_launch": [P, P, P, P, P, I, I, I, I, I, I, F, P, P],
    "bucket_conv_launch": [P] * 11 + [I] * 8 + [F, F, I, I] + [P] * 3,
    "bucket_conv_bwd_launch": [P] * 13 + [I] * 10 + [F, F, I] + [P] * 5,
    "bucket_conv_active_launch": [P] * 12 + [I] * 10 + [F, F, I, I] + [P] * 3,
    "bucket_conv_bwd_active_launch": [P] * 14 + [I] * 12 + [F, F, I] + [P] * 5,
}


class KernelLibrary:
    """The loaded shared library plus what its build printed."""

    def __init__(self, path: str, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self._lib = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self._lib, name, None)
            if fn is None:  # an older checkout's library (tools.dense_ab) lacks later entries
                continue
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def __getattr__(self, name: str):
        if name not in SIGNATURES:
            raise AttributeError(name)
        return getattr(self._lib, name)


_LOCK = threading.Lock()
_LIBRARY: KernelLibrary | None = None


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of mccnn_tpu_torch "
        "are compiled from csrc/ at first use"
    )


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sorted(glob.glob(os.path.join(CSRC_DIR, "*"))):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _LIBRARY
    with _LOCK:
        if _LIBRARY is not None:
            return _LIBRARY
        out = os.path.join(BUILD_DIR, f"libmccnn_kernels_{_digest()}.so")
        log, seconds = "", 0.0
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                log = _compile_and_link(_nvcc(), _sources(), tmp, out)
            seconds = time.perf_counter() - t0
        _LIBRARY = KernelLibrary(out, seconds, log)
        return _LIBRARY


def _compile_and_link(nvcc: str, srcs: list[str], tmp: str, out: str) -> str:
    """One ``nvcc -c`` per source, all running at once, then one link; every
    process is waited for before a failure raises. Returns nvcc's output."""
    objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(srcs, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    failed = [s for s, p in zip(srcs, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {[os.path.basename(s) for s in failed]}:\n{log}")
    lib = os.path.join(tmp, "lib.so")
    proc = subprocess.run([nvcc, "-shared", "-o", lib, *objs], capture_output=True, text=True)
    log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
    os.replace(lib, out)
    return log


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t {err}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].get_device()  # -1 on the CPU
    for t in tensors:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{name}: every input must be on the same CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
