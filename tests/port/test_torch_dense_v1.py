"""K1v1 / K2v1 (the per-h dense MC conv and its backward) of mccnn_tpu_torch
against the JAX package, on the CPU.

On CPU tensors ``dense_mc_conv`` with ``_USE_V1`` runs ``DenseMCConvV1Function``
with the plain versions (``dense_mc_conv_reference`` forward, and
``dense_mc_conv_v1_backward_reference``, which takes the count and forms G
again). These tests hold them against the reference's v1 kernels in interpret
mode (``MCCNN_DENSE_V1``'s ``_fwd_kernel`` / ``_bwd_kernel``, selected by
setting the reference module's ``_USE_V1`` before tracing; no JAX file
changes), forward and gradient in one jitted program, depthwise and full, mean
and PDF modes. The CUDA kernels are held against the same plain versions and
against K1 / K2 on the card (tests/port/test_torch_cuda.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.core.mcconv import MCConvParams as JParams
from mccnn_tpu.ops.pallas import dense_conv as j_dense_conv
from mccnn_tpu_torch.core.mcconv import MCConvParams
from mccnn_tpu_torch.ops.cuda import dense_conv
from test_torch_k2 import assert_grads_close, conv_case

CASES = {  # c_out, mean_normalize
    "depthwise": (None, False),
    "full": (4, False),
    "depthwise_mean": (None, True),
    "full_mean": (4, True),
}
RADIUS = 0.3


def _port(case, c_out, mean):
    """``(out, [dw1, db1, dw2, db2, dfeatures])`` of sum(out * cot) through
    the v1 route."""
    t = {k: torch.from_numpy(v) for k, v in case.items() if isinstance(v, np.ndarray)}
    params = [torch.from_numpy(p).requires_grad_() for p in case["params"]]
    feats = t["feats"].requires_grad_()
    out = dense_conv.dense_mc_conv(
        MCConvParams(*params), t["smp"], t["qmask"], t["src"], t["smask"], feats, t["pdf"],
        RADIUS, c_out=c_out, mean_normalize=mean,
    )
    (out * t["cot"]).sum().backward()
    return out.detach().numpy(), [p.grad.numpy() for p in params] + [feats.grad.numpy()]


@pytest.fixture(scope="module")
def jax_v1():
    """Every case's forward and gradient through the reference's interpret-mode
    v1 kernels, compiled as one program."""
    cases = {name: conv_case(21 + k, c_out, RADIUS) for k, (name, (c_out, _)) in
             enumerate(CASES.items())}
    saved = j_dense_conv._USE_V1
    j_dense_conv._USE_V1 = True  # the reference reads its switch while tracing
    try:
        def run(arrays):
            res = {}
            for name, (c_out, mean) in CASES.items():
                j = arrays[name]

                def conv(params, feats, j=j, c_out=c_out, mean=mean):
                    out = j_dense_conv.dense_mc_conv(
                        JParams(*params), j["smp"], j["qmask"], j["src"], j["smask"], feats,
                        j["pdf"], RADIUS, c_out=c_out, mean_normalize=mean, interpret=True)
                    return jnp.where(j["qmask"][..., None], out, 0.0)

                loss = lambda p, f, conv=conv, j=j: jnp.sum(conv(p, f) * j["cot"])  # noqa: E731
                gp, gf = jax.grad(loss, argnums=(0, 1))(list(j["params"]), j["feats"])
                res[name] = (conv(list(j["params"]), j["feats"]), [*gp, gf])
            return res

        arrays = {name: {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else
                             [jnp.asarray(p) for p in v])
                         for k, v in c.items() if k != "radius"}
                  for name, c in cases.items()}
        out = jax.tree.map(np.asarray, jax.jit(run)(arrays))
    finally:
        j_dense_conv._USE_V1 = saved
    return cases, out


@pytest.mark.parametrize("name", list(CASES))
def test_v1_plain_versions_match_jax_v1_interpret(jax_v1, monkeypatch, name):
    monkeypatch.setattr(dense_conv, "_USE_V1", True)
    cases, want = jax_v1
    c_out, mean = CASES[name]
    before = (dense_conv.launches_v1, dense_conv.backward_launches_v1)
    out, grads = _port(cases[name], c_out, mean)
    assert (dense_conv.launches_v1, dense_conv.backward_launches_v1) == before  # plain on CPU
    want_out, want_grads = want[name]
    # 2e-2: the TPU kernels run features, planes and dout in bf16 (the K1 / K2
    # comparisons in interpret mode hold the same, test_torch_k2.py)
    scale = np.abs(want_out).max()
    np.testing.assert_allclose(out, want_out, rtol=2e-2, atol=2e-2 * scale)
    assert_grads_close(grads, want_grads, 2e-2)


@pytest.mark.parametrize("name", ["full", "depthwise_mean"])
def test_v1_route_equals_the_default_route_on_cpu(monkeypatch, name):
    # the same plain forward, and K2's plain backward with G formed again
    c_out, mean = CASES[name]
    case = conv_case(31, c_out, RADIUS)
    default = _port(case, c_out, mean)
    monkeypatch.setattr(dense_conv, "_USE_V1", True)
    v1 = _port(case, c_out, mean)
    np.testing.assert_array_equal(v1[0], default[0])
    for g, w in zip(v1[1], default[1]):
        # the v1 plain backward rounds pre_h as mc_preact and divides by a
        # device tensor: the same ReLU steps here, sums in the same order
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("c_out,mean", [(3, False), (None, True)])
def test_v1_function_gradcheck_float64(c_out, mean):
    g = torch.Generator().manual_seed(6)
    B, N, M, C = 2, 12, 5, 2
    src = torch.rand((B, N, 3), generator=g, dtype=torch.float64)
    smp = torch.rand((B, M, 3), generator=g, dtype=torch.float64)
    smask = torch.ones((B, N), dtype=torch.bool)
    smask[:, -2:] = False
    qmask = torch.ones((B, M), dtype=torch.bool)
    qmask[1, -1] = False
    out_dim = C if c_out is None else C * c_out
    inputs = [torch.randn(s, generator=g, dtype=torch.float64).requires_grad_()
              for s in [(3, 8), (8,), (8, out_dim), (out_dim,), (B, N, C)]]

    def f(w1, b1, w2, b2, wf):
        out, _ = dense_conv.DenseMCConvV1Function.apply(
            w1, b1, w2, b2, wf, smp, qmask, src, smask, 0.6, c_out, mean)
        return out

    assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-6, rtol=1e-5)
