"""K2 (the dense MC-conv backward) of mccnn_tpu_torch against the JAX package, on the CPU.

On CPU tensors ``dense_mc_conv`` runs ``DenseMCConvFunction`` with the plain
forward and the plain backward (``dense_mc_conv_backward_reference``), so
these tests hold the autograd wiring and K2's plain version against
``jax.grad`` of the reference: the lossless neighbour-list ``mc_conv`` with
``k = N`` (fp32 on both sides) and the dense Pallas kernel in interpret mode
(bf16 inside). The CUDA kernel is held against the same plain version on the
card (tests/port/test_torch_cuda.py and chip_smoke.py). Inputs come from a
seeded numpy generator with masked samples and sources.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.core import mc_conv, radius_neighbors
from mccnn_tpu.core.mcconv import MCConvParams as JParams
from mccnn_tpu.ops.pallas import dense_mc_conv as j_dense_mc_conv
from mccnn_tpu_torch.core.mcconv import MCConvParams
from mccnn_tpu_torch.ops.cuda import dense_conv
from parity_utils import boundary_free

GLOBAL = math.sqrt(3.0) + 0.1

CASES = {  # c_out, mean_normalize, radius
    "depthwise": (None, False, 0.3),
    "full": (4, False, 0.3),
    "depthwise_mean": (None, True, 0.3),
    "full_mean": (4, True, 0.3),
    "full_global": (4, False, GLOBAL),
}


def conv_case(seed, c_out, radius, B=2, N=64, M=24, C=6, duplicates=False):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 1, size=(B, N, 3)).astype(np.float32)
    smp = rng.uniform(0, 1, size=(B, M, 3)).astype(np.float32)
    if duplicates:
        # as a hierarchy level: samples are source points, and (as
        # --pt-drop-max does) part of each cloud collapses onto its first point
        smp = src[:, ::2][:, :M].copy()
        src[:, 1:N:4] = src[:, :1]
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    smask = np.ones((B, N), bool)
    smask[:, -7:] = False
    qmask = np.ones((B, M), bool)
    qmask[:, -5:] = False
    pdf = rng.uniform(0.5, 2.0, size=(B, N)).astype(np.float32)
    out_dim = C if c_out is None else C * c_out
    params = [
        rng.normal(size=(3, 8)).astype(np.float32) * (2.0 / 3.0) ** 0.5,
        rng.normal(size=(8,)).astype(np.float32) * 0.1,
        rng.normal(size=(8, out_dim)).astype(np.float32) * 0.5,
        rng.normal(size=(out_dim,)).astype(np.float32) * 0.1,
    ]
    cot = rng.normal(size=(B, M, C if c_out is None else c_out)).astype(np.float32)
    return dict(src=src, smp=smp, feats=feats, smask=smask, qmask=qmask, pdf=pdf,
                params=params, cot=cot, radius=radius)


def port_grads(case, c_out, mean):
    """Gradients of sum(out * cot) through ``dense_mc_conv`` (the Function)."""
    t = {k: torch.from_numpy(v) for k, v in case.items() if isinstance(v, np.ndarray)}
    params = [torch.from_numpy(p).requires_grad_() for p in case["params"]]
    feats = t["feats"].requires_grad_()
    out = dense_conv.dense_mc_conv(
        MCConvParams(*params), t["smp"], t["qmask"], t["src"], t["smask"], feats, t["pdf"],
        case["radius"], c_out=c_out, mean_normalize=mean,
    )
    (out * t["cot"]).sum().backward()
    return [p.grad.numpy() for p in params] + [feats.grad.numpy()]


def jax_grads(case, c_out, mean, conv):
    j = {k: jnp.asarray(v) for k, v in case.items() if isinstance(v, np.ndarray)}

    def loss(params, feats):
        out = conv(JParams(*params), j, feats)
        return jnp.sum(jnp.where(j["qmask"][..., None], out, 0.0) * j["cot"])

    gp, gf = jax.grad(loss, argnums=(0, 1))([jnp.asarray(p) for p in case["params"]],
                                            j["feats"])
    return [np.asarray(g) for g in gp] + [np.asarray(gf)]


def lossless(case, c_out, mean):
    def conv(params, j, feats):
        # k = N makes the neighbour-list conv lossless (test_dense_conv.py:24-27)
        nbh = radius_neighbors(j["smp"], j["qmask"], j["src"], j["smask"], case["radius"],
                               case["src"].shape[1])
        return mc_conv(params, j["smp"], nbh, j["src"], feats, j["pdf"], c_out=c_out,
                       mean_normalize=mean)

    return jax_grads(case, c_out, mean, conv)


def assert_grads_close(got, want, rel):
    names = ["dw1", "db1", "dw2", "db2", "dfeatures"]
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=rel, atol=rel * scale, err_msg=name)


@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_jax_lossless_grad(name):
    c_out, mean, radius = CASES[name]
    case = conv_case(11, c_out, radius)
    assert boundary_free(np.concatenate([case["src"], case["smp"]], 1),
                         np.concatenate([case["smask"], case["qmask"]], 1), [radius])
    # 1e-4 of each tensor's largest value: both sides fp32, the pair sums and
    # the (H+1)*C contractions taken in other orders.
    assert_grads_close(port_grads(case, c_out, mean), lossless(case, c_out, mean), 1e-4)


@pytest.mark.parametrize("name", ["full", "depthwise_mean"])
def test_backward_on_duplicated_points_matches_jax_lossless_grad(name):
    c_out, mean, radius = CASES[name]
    case = conv_case(12, c_out, radius, duplicates=True)
    assert_grads_close(port_grads(case, c_out, mean), lossless(case, c_out, mean), 1e-4)


@pytest.mark.parametrize("name", ["full", "depthwise_mean"])
def test_backward_matches_jax_dense_kernel_interpret(name):
    c_out, mean, radius = CASES[name]
    case = conv_case(13, c_out, radius)

    def conv(params, j, feats):
        return j_dense_mc_conv(params, j["smp"], j["qmask"], j["src"], j["smask"], feats,
                               j["pdf"], case["radius"], c_out=c_out, mean_normalize=mean,
                               interpret=True)

    # 3e-2: the TPU kernel's backward runs dout, features and planes in bf16
    # (the reference's own forward tolerance is 2e-2, test_dense_conv.py:43;
    # the backward adds the rounding of dout).
    assert_grads_close(port_grads(case, c_out, mean),
                       jax_grads(case, c_out, mean, conv), 3e-2)


@pytest.mark.parametrize("c_out,mean", [(3, False), (None, True)])
def test_function_gradcheck_float64(c_out, mean):
    g = torch.Generator().manual_seed(5)
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
        out, _ = dense_conv.DenseMCConvFunction.apply(
            w1, b1, w2, b2, wf, smp, qmask, src, smask, 0.6, c_out, mean)
        return out

    assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-6, rtol=1e-5)


def test_relu_step_at_zero_and_masked_rows():
    case = conv_case(14, 4, 0.3)
    t = {k: torch.from_numpy(v) for k, v in case.items() if isinstance(v, np.ndarray)}
    w1, b1, w2, b2 = (torch.from_numpy(p) for p in case["params"])
    w1[:, 2], b1[2] = 0.0, 0.0  # pre_2 == 0 exactly on every pair
    params = MCConvParams(w1, b1, w2, b2)
    wf = dense_conv._weighted_features(t["feats"], t["pdf"], t["smask"])
    out, cnt, G = dense_conv._forward_reference(params, t["smp"], t["qmask"], t["src"],
                                                t["smask"], wf, 0.3, 4, False)
    d_wf, dw1, db1, dw2, db2 = dense_conv.dense_mc_conv_backward_reference(
        params, t["smp"], t["qmask"], t["src"], t["smask"], wf, 0.3, G, cnt, t["cot"],
        c_out=4)
    # jnp.where(pre > 0, ...) gives the step value 0 at pre == 0
    assert torch.all(dw1[:, 2] == 0) and db1[2] == 0
    assert torch.all(dw1.abs().sum(0)[[0, 1, 3]] > 0)
    # masked sources receive nothing; masked samples send nothing
    assert torch.all(d_wf[~t["smask"]] == 0)
    cot = t["cot"].clone()
    cot[~t["qmask"]] = 1e3
    again = dense_conv.dense_mc_conv_backward_reference(
        params, t["smp"], t["qmask"], t["src"], t["smask"], wf, 0.3, G, cnt, cot, c_out=4)
    for a, b in zip(again, (d_wf, dw1, db1, dw2, db2)):
        assert torch.equal(a, b)


def test_positions_and_pdf_get_no_gradient():
    case = conv_case(15, None, 0.3)
    t = {k: torch.from_numpy(v) for k, v in case.items() if isinstance(v, np.ndarray)}
    src, pdf = t["src"].requires_grad_(), t["pdf"]
    params = MCConvParams(*(torch.from_numpy(p).requires_grad_() for p in case["params"]))
    out = dense_conv.dense_mc_conv(params, t["smp"], t["qmask"], src, t["smask"], t["feats"],
                                   pdf, 0.3)
    out.sum().backward()
    assert src.grad is None  # the Function returns no gradient for positions
    assert all(p.grad is not None for p in params)
