"""K6 (the tile MC-conv backward) of mccnn_tpu_torch against the JAX package, on the CPU.

On CPU tensors ``tile_mc_conv`` runs ``TileMCConvFunction`` with the plain
K5 forward and the plain K6 backward (``tile_conv_backward_sorted_reference``),
which walks the backward step list (source majors x sample minors) as the
reference's ``_bwd_kernel`` does. These tests hold it against ``jax.grad``
of the lossless neighbour-list ``mc_conv`` (``k = N``, fp32) and against the
reference's tile kernels in interpret mode (bf16 inside), at a full step
budget and at ``max_steps = 2``, where the forward and backward lists drop
different pairs. The CUDA kernel is held against the same plain version on
the card (``test_torch_cuda.py`` and ``chip_smoke.py``).

The reference's custom VJP returns cotangents of shape (B, S) for its
(B, G, S) minor-id operands (``mccnn_tpu/ops/pallas/tile_conv.py:1192-1193``),
which ``jax.grad`` rejects whenever G > 1, as at every default layout. The
kernels themselves are sound: ``vjp_safe_core`` calls the reference's own
``_core_fwd`` / ``_core_bwd`` unchanged and only gives those two operands
zero cotangents of their own shapes. It is installed for this module's
interpret-mode references; the JAX package is not changed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mccnn_tpu.core import mc_conv, radius_neighbors
from mccnn_tpu.core.mcconv import MCConvParams as JParams
from mccnn_tpu.ops.pallas import tile_conv as J
from mccnn_tpu_torch.core.mcconv import MCConvParams
from mccnn_tpu_torch.ops.cuda import tile_conv as P

RADIUS = 0.25
SEED = 22  # boundary_free
CASES = {  # c_out, mean_normalize
    "depthwise": (None, False),
    "full": (4, False),
    "depthwise_mean": (None, True),
    "full_mean": (4, True),
}
NAMES = ("dw1", "db1", "dw2", "db2", "dfeatures")


def grad_case(seed, c_in, c_out, M=180, N=400):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 1, size=(2, N, 3)).astype(np.float32)
    smp = rng.uniform(0, 1, size=(2, M, 3)).astype(np.float32)
    smask = np.ones((2, N), bool)
    smask[0, -50:] = False
    qmask = np.ones((2, M), bool)
    qmask[1, -20:] = False
    feats = rng.normal(size=(2, N, c_in)).astype(np.float32)
    pdf = rng.uniform(0.5, 2.0, size=(2, N)).astype(np.float32)
    out_dim = c_in if c_out is None else c_in * c_out
    params = [rng.normal(size=(3, 8)) * 0.8, rng.normal(size=8) * 0.1,
              rng.normal(size=(8, out_dim)) * 0.5, rng.normal(size=out_dim) * 0.1]
    cot = rng.normal(size=(2, M, c_in if c_out is None else c_out))
    return dict(smp=smp, qmask=qmask, src=src, smask=smask, feats=feats, pdf=pdf,
                params=[p.astype(np.float32) for p in params], cot=cot.astype(np.float32))


def boundary_free(case, tol=1e-6):
    """No valid (sample, source) pair with |d^2 - r^2| < tol (float64): the two
    packages round d2 differently, so a pair on the radius may be in on one
    side and out on the other."""
    d = case["smp"][:, :, None].astype(np.float64) - case["src"][:, None].astype(np.float64)
    near = np.abs((d**2).sum(-1) - RADIUS**2) < tol
    return not (near & case["qmask"][:, :, None] & case["smask"][:, None]).any()


def port_grads(case, c_out, mean, max_steps=None):
    """Gradients of sum(out * cot) through ``tile_mc_conv`` and the overflow."""
    t = {k: torch.from_numpy(v) for k, v in case.items() if isinstance(v, np.ndarray)}
    params = [torch.from_numpy(p).requires_grad_() for p in case["params"]]
    feats = t["feats"].requires_grad_()
    out, ovf = P.tile_mc_conv(MCConvParams(*params), t["smp"], t["qmask"], t["src"], t["smask"],
                              feats, t["pdf"], RADIUS, max_pairs=1 << 30, max_steps=max_steps,
                              c_out=c_out, mean_normalize=mean, with_overflow=True)
    (out * t["cot"]).sum().backward()
    return [p.grad.numpy() for p in params] + [feats.grad.numpy()], ovf.numpy()


def jax_grads(case, conv):
    """``jax.grad`` of sum(where(qmask, out, 0) * cot) for ``conv(params,
    feats)`` (traced: call it inside ``jax.jit``)."""

    def loss(params, feats):
        out = conv(JParams(*params), feats)
        return jnp.sum(jnp.where(case["qmask"][..., None], out, 0.0) * case["cot"])

    gp, gf = jax.grad(loss, argnums=(0, 1))(case["params"], case["feats"])
    return [*gp, gf]


def assert_grads_close(got, want, rel):
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=rel, atol=rel * scale, err_msg=name)


@pytest.fixture(scope="module")
def lossless():
    """Each case's inputs and the JAX lossless gradients, one compiled program."""
    cases = {name: grad_case(SEED, 5, c_out) for name, (c_out, _) in CASES.items()}
    assert all(boundary_free(c) for c in cases.values())

    @jax.jit
    def all_grads(cases):
        out = {}
        for name, (c_out, mean) in CASES.items():
            c = cases[name]
            # k = N makes the neighbour-list conv lossless (test_dense_conv.py:24-27)
            nbh = radius_neighbors(c["smp"], c["qmask"], c["src"], c["smask"], RADIUS,
                                   c["src"].shape[1])
            out[name] = jax_grads(c, lambda prm, f, c=c, nbh=nbh, c_out=c_out, mean=mean: mc_conv(
                prm, c["smp"], nbh, c["src"], f, c["pdf"], c_out=c_out, mean_normalize=mean))
        return out

    return cases, all_grads(cases)


@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_jax_lossless_grad(lossless, name):
    cases, want = lossless
    c_out, mean = CASES[name]
    got, ovf = port_grads(cases[name], c_out, mean)
    assert (ovf == 0).all()
    # 1e-4 of each tensor's largest value: both sides fp32, the pair sums and
    # the (H+1) x C contractions taken in other orders
    assert_grads_close(got, want[name], 1e-4)


def vjp_safe_core():
    """The reference's ``_tile_conv_core`` with ``_core_fwd`` / ``_core_bwd``
    unchanged, but zero cotangents of the right shapes for the forward
    list's ``i_f`` (B, S) and ``j_f`` (B, G, S)."""

    @functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
    def core(spec, w1, b1, w2, b2, smp_t, smp_pos_m, src_pos_m, src_t, src_feat_m,
             src_feat_M, i_f, j_f, jb_f, ib_f):
        return J._core_fwd(spec, w1, b1, w2, b2, smp_t, smp_pos_m, src_pos_m, src_t,
                           src_feat_m, src_feat_M, i_f, j_f, jb_f, ib_f)[0]

    def fwd(spec, *args):
        out, res = J._core_fwd(spec, *args)
        return out, (res, args[10], args[11])

    def bwd(spec, saved, cts):
        res, i_f, j_f = saved
        grads = list(J._core_bwd(spec, res, cts))
        grads[10], grads[11] = jnp.zeros_like(i_f), jnp.zeros_like(j_f)
        return tuple(grads)

    core.defvjp(fwd, bwd)
    return core


SHORT = 2  # max_steps: both lists drop steps, and different pairs


@pytest.fixture(scope="module")
def interpret():
    """One depthwise case and the gradients of the JAX tile conv in interpret
    mode at a full budget and at ``max_steps = SHORT``, one compiled program."""
    case = grad_case(10, 8, None, M=260)
    assert boundary_free(case)

    @jax.jit
    def both(c):
        out = []
        for max_steps in (None, SHORT):
            conv = functools.partial(
                lambda prm, f, ms: J.tile_mc_conv(prm, c["smp"], c["qmask"], c["src"],
                                                  c["smask"], f, c["pdf"], RADIUS,
                                                  max_pairs=1 << 30, max_steps=ms,
                                                  interpret=True), ms=max_steps)
            out.append(jax_grads(c, conv))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "_tile_conv_core", vjp_safe_core())
        grads = both(case)
    return case, grads


@pytest.mark.parametrize("max_steps", [None, SHORT])
def test_backward_matches_jax_interpret_kernel(interpret, max_steps):
    case, (full, short) = interpret
    want = full if max_steps is None else short
    got, ovf = port_grads(case, None, False, max_steps)
    assert (ovf > 0).all() if max_steps else (ovf == 0).all()
    # rtol 2e-2: the reference's K6 runs planes, features and the cotangent
    # in bf16 (its own forward tolerance is 2e-2, test_dense_conv.py:43)
    assert_grads_close(got, want, 2e-2)
    if max_steps:
        # the short budget drops pairs: far from the full gradient, which
        # the port reaches only by walking the backward list as K6 does
        far = [np.abs(np.asarray(s) - np.asarray(f)).max() / np.abs(np.asarray(f)).max()
               for s, f in zip(short, full)]
        assert min(far) > 0.1, far


@pytest.mark.parametrize("c_out,mean", [(3, False), (None, True)])
def test_function_gradcheck_float64(c_out, mean):
    g = torch.Generator().manual_seed(7)
    B, N, M, C = 2, 100, 60, 2
    src = torch.rand((B, N, 3), generator=g, dtype=torch.float64)
    smp = torch.rand((B, M, 3), generator=g, dtype=torch.float64)
    smask = torch.ones((B, N), dtype=torch.bool)
    smask[:, -9:] = False
    qmask = torch.ones((B, M), dtype=torch.bool)
    qmask[1, -4:] = False
    lay = P.conv_layout(smp, qmask, src, smask, 0.4, max_pairs=1 << 30, backward=True)
    out_dim = C if c_out is None else C * c_out
    inputs = [torch.randn(s, generator=g, dtype=torch.float64).requires_grad_()
              for s in [(3, 8), (8,), (8, out_dim), (out_dim,), (B, lay.src.shape[1], C)]]

    def f(w1, b1, w2, b2, wf):
        return P.TileMCConvFunction.apply(w1, b1, w2, b2, wf, lay, 0.4, c_out, mean)

    assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-6, rtol=1e-5, fast_mode=True)


def test_relu_step_at_zero_masked_rows_and_no_position_gradient():
    case = grad_case(14, 3, 4, M=100, N=200)
    t = {k: torch.from_numpy(v) for k, v in case.items() if isinstance(v, np.ndarray)}
    w1, b1, w2, b2 = (torch.from_numpy(p) for p in case["params"])
    w1[:, 2], b1[2] = 0.0, 0.0  # pre_2 == 0 exactly on every pair
    params = MCConvParams(w1, b1, w2, b2)
    lay = P.conv_layout(t["smp"], t["qmask"], t["src"], t["smask"], RADIUS, max_pairs=1 << 30,
                        backward=True)
    wf = P._sorted_weighted_features(lay, t["feats"], t["pdf"])
    out, cnt = P.tile_conv_sorted_reference(params, lay, wf, RADIUS, c_out=4)
    dout = torch.from_numpy(np.random.default_rng(3).normal(size=out.shape).astype(np.float32))
    d_wf, dw1, db1, dw2, db2 = P.tile_conv_backward_sorted_reference(params, lay, wf, RADIUS,
                                                                     cnt, dout, c_out=4)
    # jnp.where(pre > 0, ...) gives the step value 0 at pre == 0
    assert torch.all(dw1[:, 2] == 0) and db1[2] == 0
    assert torch.all(dw1.abs().sum(0)[[0, 1, 3]] > 0)
    # invalid and padding source rows receive nothing; invalid samples send nothing
    assert torch.all(d_wf[~lay.src_valid] == 0) and float(d_wf.abs().max()) > 0
    noisy = torch.where(lay.smp_valid[..., None], dout, 1e3)
    again = P.tile_conv_backward_sorted_reference(params, lay, wf, RADIUS, cnt, noisy, c_out=4)
    for a, b in zip(again, (d_wf, dw1, db1, dw2, db2)):
        assert torch.equal(a, b)
    # positions get no gradient (the reference's _core_bwd returns zeros)
    src = t["src"].requires_grad_()
    prm = MCConvParams(*(p.requires_grad_() for p in params))
    P.tile_mc_conv(prm, t["smp"], t["qmask"], src, t["smask"], t["feats"], t["pdf"], RADIUS,
                   max_pairs=1 << 30, c_out=4).sum().backward()
    assert src.grad is None and all(p.grad is not None for p in prm)
