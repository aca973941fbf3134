"""T1's plain versions (``mccnn_tpu_torch/ops/cuda/dense_probe.py``) against the
Pallas bodies of ``tools/exp_dense_breakdown.py``, on the CPU.

The tool times every variant when it is imported, at its full size, so it is
never imported: its file is parsed with ``ast`` and only ``_prep`` and the
``k_*`` kernel bodies are executed, in a namespace whose sizes (``B``, ``N``,
``M``, ``C``, ``H``, ``TILE``, ``RADIUS``) are this test's small ones. The
bodies run through ``pl.pallas_call(..., interpret=True)`` laid out as the
tool's ``call`` (``:84-94``, one grid step per sample tile) and ``call_big``
(``:186-198``, one per cloud) lay them out, all seven in one compiled
program, on the tool's kind of inputs (uniform points, normal features cast
to bf16, normal ``w1`` of 8 rows, ``b1``, ``w2``, ``b2``). The kernels are held
against the same plain versions on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mccnn_tpu.ops.pallas.mcconv_kernel import LANE, W1_ROWS, _mm, _pair_d2
from mccnn_tpu_torch.ops.cuda import dense_probe

TOOL = pathlib.Path(__file__).resolve().parents[2] / "tools" / "exp_dense_breakdown.py"
B, N, C, H, TILE, RADIUS = 2, 256, 16, 8, 128, 0.2
BODIES = {"mm_only": "k_mm_only", "vpu_only": "k_vpu_only", "replica": "k_fwd_replica",
          "h1": "k_h1", "noop": "k_noop", "fwd_bf16": "k_fwd_bf16"}  # run by `call`


def tool_namespace() -> dict:
    """``_prep`` and the ``k_*`` bodies of the tool, executed at this test's sizes."""
    tree = ast.parse(TOOL.read_text())
    keep = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and (n.name.startswith("k_") or n.name == "_prep")]
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, _pair_d2=_pair_d2, _mm=_mm,
              W1_ROWS=W1_ROWS, LANE=LANE, B=B, N=N, M=N, C=C, H=H, TILE=TILE, RADIUS=RADIUS)
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(TOOL), "exec"), ns)  # noqa: S102
    return ns


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(pts=rng.uniform(0, 1, size=(B, N, 3)).astype(np.float32),
                feats=rng.normal(size=(B, N, C)).astype(np.float32),
                w1=rng.normal(size=(W1_ROWS, H)).astype(np.float32),
                b1=rng.normal(size=(H, 1)).astype(np.float32),
                w2=rng.normal(size=(H, C)).astype(np.float32),
                b2=rng.normal(size=(1, C)).astype(np.float32))


@pytest.fixture(scope="module")
def tool_outputs():
    """Every body's output, one compiled program of interpret-mode kernels."""
    ns = tool_namespace()
    vm = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    n_tiles = N // TILE

    def ix(s):
        return (jax.lax.div(s, jnp.int32(n_tiles)), jax.lax.rem(s, jnp.int32(n_tiles)), 0)

    def call(kernel, *args):  # the tool's `call`, interpreted
        return pl.pallas_call(
            kernel, grid=(B * n_tiles,),
            in_specs=[vm((1, 8, TILE), ix), vm((1, N, LANE), lambda s: (ix(s)[0], 0, 0)),
                      vm((1, N, C), lambda s: (ix(s)[0], 0, 0)), vm(), vm(), vm(), vm()],
            out_specs=vm((1, TILE, C), ix),
            out_shape=jax.ShapeDtypeStruct((B, N, C), jnp.float32), interpret=True)(*args)

    def call_big(kernel, *args):  # the tool's `call_big`, interpreted
        cloud = lambda s: (s, 0, 0)  # noqa: E731
        return pl.pallas_call(
            kernel, grid=(B,),
            in_specs=[vm((1, 8, TILE), cloud), vm((1, N, LANE), cloud), vm((1, N, C), cloud),
                      vm(), vm(), vm(), vm()],
            out_specs=vm((1, N, C), cloud),
            out_shape=jax.ShapeDtypeStruct((B, N, C), jnp.float32), interpret=True)(*args)

    @jax.jit
    def run(x):
        ns["pts"] = x["pts"]  # the global _prep reads
        src_pos, smp_t = ns["_prep"]()
        args = (smp_t, src_pos, x["feats"].astype(jnp.bfloat16), x["w1"], x["b1"], x["w2"],
                x["b2"])
        out = {v: call(ns[body], *args) for v, body in BODIES.items()}
        out["mm_big"] = call_big(ns["k_mm_big"], *args)
        return out

    x = inputs()
    out = {k: np.asarray(v) for k, v in run({k: jnp.asarray(v) for k, v in x.items()}).items()}
    ns.pop("pts")
    return x, out


def port(variant, x):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    return dense_probe.dense_probe(variant, t["pts"], t["feats"], t["w1"], t["b1"].reshape(H),
                                   t["w2"], t["b2"].reshape(C), RADIUS).numpy()


@pytest.mark.parametrize("variant", dense_probe.VARIANTS)
def test_t1_plain_versions_match_the_tool_bodies(tool_outputs, variant):
    x, want = tool_outputs
    before = dict(dense_probe.launches)
    got = port(variant, x)
    assert dense_probe.launches == before  # the plain version on the CPU
    ref = want[variant]
    assert got.shape == ref.shape == (B, N, C)
    if variant == "noop":
        np.testing.assert_array_equal(got, ref)
        return
    scale = np.abs(ref).max()
    assert scale > 0
    # Relative to the largest output: both round the planes to bf16 at the
    # same places and sum the products with the bf16 features in fp32, in
    # other orders (1.5e-5 of the largest output or less on this input, 0 for
    # h1): 1e-4. vpu_only's running bf16 plane sum rounds eight times, so an
    # add that rounds apart in XLA's interpret-mode loop moves an element of
    # the plane by a bf16 ulp (1.3e-3 of the largest output here): 5e-3.
    rel = 5e-3 if variant == "vpu_only" else 1e-4
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * scale)


def test_mm_big_is_mm_only_and_xla_equiv_its_matmul():
    x = {k: torch.from_numpy(v) for k, v in inputs(1).items()}
    x["pts"], x["feats"] = x["pts"][:, :64], x["feats"][:, :64]
    args = (x["pts"], x["feats"], x["w1"], x["b1"].reshape(H), x["w2"], x["b2"].reshape(C), RADIUS)
    small = dense_probe.dense_probe_reference("mm_only", *args)
    assert torch.equal(dense_probe.dense_probe_reference("mm_big", *args), small)
    lib = dense_probe.xla_equiv(x["pts"], x["feats"], x["w2"])
    torch.testing.assert_close(lib, small, rtol=1e-4, atol=1e-4 * float(small.abs().max()))


def test_t1_refuses_an_unknown_variant_and_cpu_tensors_for_the_kernel():
    x = {k: torch.from_numpy(v) for k, v in inputs(2).items()}
    args = (x["pts"], x["feats"], x["w1"], x["b1"].reshape(H), x["w2"], x["b2"].reshape(C), RADIUS)
    with pytest.raises(ValueError, match="T1 variant"):
        dense_probe.dense_probe("layer", *args)
    with pytest.raises(ValueError, match="CUDA"):
        dense_probe.dense_probe_cuda("replica", *args)


def test_breakdown_split_and_the_walked_floor():
    """``tools.dense_breakdown``'s split reads each schedule's parts from
    its own variants, and mm_only's walked floor is its (H+1) fp32
    contractions over every pair at the tool's shape: 19.33 GFLOP, 0.2885 ms
    at 67 TFLOP/s."""
    from mccnn_tpu_torch.tools import dense_breakdown as db

    times = {"noop": 0.01, "mm_only": 0.41, "mm_big": 0.11, "replica": 1.61, "vpu_only": 0.49,
             "h1": 0.42, "fwd": 0.6}
    parts = db.split(times)
    assert parts["loads"] == 0.01
    assert parts["cuda_core_contraction"] == pytest.approx(0.40)
    assert parts["tensor_core_contraction"] == pytest.approx(0.10)
    assert parts["cuda_over_tensor"] == pytest.approx(4.0)
    assert parts["k1_contraction"] == pytest.approx(0.14)
    assert parts["k1_plane"] == pytest.approx(0.01)
    assert parts["k1_loads"] == pytest.approx(0.27)
    assert db.split({"noop": 0.01, "mm_only": 0.4}) == {}  # a part needs all its variants
    pairs = db.B * db.M * db.N
    assert db.t1_ops("mm_only", pairs, 0, walked=True) == pairs * 2 * (db.H + 1) * db.C
    assert db.t1_ops("mm_only", pairs, 0, walked=True) == 19_327_352_832
    assert db.t1_floor("mm_only", pairs, 0, walked=True) == pytest.approx(0.28847, rel=1e-4)
