"""The port's sampler backward and the f2v accumulator against the JAX package.

The plain backward (``quad_sample_bwd_plain``, reached through the autograd
Function of ``grid_sample_2d_quad_kernel`` on CPU tensors) is held to
``jax.grad`` through ``grid_sample_2d_quad_pallas`` (its K2 ``_scatter_outer``
in the rows layout and K2p ``_scatter_outer_planes`` in the planes layout, in
interpret mode with a 64-row tile) and through the XLA ``grid_sample_2d_quad``.
The CUDA kernel itself is held to the plain version by test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgsfusion_tpu.ops import pallas_sample
from hgsfusion_tpu.ops.grid_sample import grid_sample_2d_quad as jax_quad
from hgsfusion_tpu.ops.pallas_sample import grid_sample_2d_quad_pallas
from hgsfusion_tpu_torch.models.frustum import FrustumToVoxelMultiScale
from hgsfusion_tpu_torch.ops.grid_sample import quad_sample_bwd_plain
from hgsfusion_tpu_torch.ops.quad_sample import grid_sample_2d_quad_kernel, quad_indices
from torch_parity import assert_close, one_torch_thread, t  # noqa: F401

SHAPES = [(1, 9, 13, 64), (2, 7, 5, 192)]
# f32: the bound the JAX package holds its pallas gradient to (test_pallas_sample.py:142)
F32_TOL = 1e-5
BF16_U = 2.0 ** -8  # bf16 unit round-off


@pytest.fixture(params=["rows", "planes"])
def pallas_layout(monkeypatch, request):
    monkeypatch.setattr(pallas_sample, "TILE", 64)
    monkeypatch.setattr(pallas_sample, "LAYOUT", request.param)


def _inputs(seed, shape, queries=(10, 13)):
    """Features, normalized coords incl. out-of-bounds (-1.3 .. 1.3) and an
    output cotangent."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(*shape).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (shape[0],) + queries + (2,)).astype(np.float32)
    cot = rng.randn(*coords.shape[:-1], shape[-1]).astype(np.float32)
    return feats, coords, cot


def _port_grad(feats, coords, cot, dtype):
    f = t(feats, dtype).requires_grad_()
    out = grid_sample_2d_quad_kernel(f, t(coords))
    (out.float() * t(cot)).sum().backward()
    return f.grad


def _jax_grads(feats, coords, cot, dtype):
    fj = jnp.asarray(feats).astype(dtype)
    cj, ctj = jnp.asarray(coords), jnp.asarray(cot)
    return [jax.grad(lambda f: jnp.sum(fn(f, cj).astype(jnp.float32) * ctj))(fj)
            for fn in (grid_sample_2d_quad_pallas, jax_quad)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_f32(shape, pallas_layout):
    feats, coords, cot = _inputs(0, shape)
    got = _port_grad(feats, coords, cot, torch.float32)
    assert got.shape == shape and got.dtype == torch.float32
    for ref in _jax_grads(feats, coords, cot, jnp.float32):
        assert_close(got, ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_bf16(shape, pallas_layout):
    """bf16: the port sums each pixel's n contributions in f32 and rounds
    once; the JAX K2 rounds every product and every sum in bf16 (its
    accumulator has the cotangent's dtype) and _unshift adds the four tap
    blocks in bf16, 3 more roundings. So per pixel the two differ by at
    most (n + 5) u S, with S the pixel's sum of |w g| and u = 2^-8."""
    feats, coords, cot = _inputs(1, shape)
    got = _port_grad(feats, coords, cot, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    b, h, w, c = shape
    idx, w4 = quad_indices(t(feats, torch.bfloat16), t(coords))
    g = t(cot, torch.bfloat16).float().reshape(-1, c)
    padded = (b, h + 2, w + 2, c)
    s_abs = quad_sample_bwd_plain(g.abs(), idx, w4.abs(), padded).numpy()
    n = quad_sample_bwd_plain(torch.ones_like(g), idx, (w4 != 0).float(), padded).numpy()
    tol = (n + 5) * BF16_U * s_abs + 1e-6
    assert n.max() >= 3  # the test shape does accumulate
    for ref in _jax_grads(feats, coords, cot, jnp.bfloat16):
        diff = np.abs(got.float().numpy() - np.asarray(ref.astype(jnp.float32)))
        assert (diff <= tol).all(), float((diff - tol).max())


def test_backward_gradcheck_f64():
    rng = np.random.RandomState(2)
    feats = torch.from_numpy(rng.randn(2, 4, 5, 3)).requires_grad_()
    coords = torch.from_numpy(rng.uniform(-1.2, 1.2, (2, 3, 4, 2)))
    assert torch.autograd.gradcheck(lambda f: grid_sample_2d_quad_kernel(f, coords), (feats,))


def test_coords_get_no_gradient():
    feats, coords, _ = _inputs(3, SHAPES[0])
    c = t(coords).requires_grad_()
    grid_sample_2d_quad_kernel(t(feats).requires_grad_(), c).sum().backward()
    assert c.grad is None


def test_f2v_accumulator_keeps_each_product_unrounded():
    """bf16: the accumulator before the BN equals bias + sum over gather
    groups of sampled @ kernel rows, computed in f64 from the same bf16
    operands, to within f32 rounding of a sum of K + 2 terms (K = 64 input
    channels), as the JAX package's einsum(..., preferred_element_type=
    float32) into an f32 accumulator gives it."""
    rng = np.random.RandomState(4)
    feats = [t(rng.randn(1, 9, 13, 16).astype(np.float32), torch.bfloat16)] + [
        t(rng.randn(1, 5, 7, 16).astype(np.float32), torch.bfloat16) for _ in range(3)]
    grid = t(rng.uniform(-1.2, 1.2, (1, 6, 7, 5, 3)).astype(np.float32))
    f2v = FrustumToVoxelMultiScale([16] * 4, 24, dtype=torch.bfloat16)
    with torch.no_grad():
        f2v.channel_reduce[0].weight.normal_(0.0, 0.25)
        f2v.channel_reduce[0].bias.normal_(0.0, 1.0)
        vox = f2v.accumulate(feats, grid)
        assert vox.dtype == torch.float32
        conv = f2v.channel_reduce[0]
        kernel = conv.weight.reshape(24, 64).t().to(torch.bfloat16).double()
        uv = grid[..., 0:2]
        groups = [(feats[0], 0, 16), (torch.cat(feats[1:], dim=-1), 16, 64)]
        ref = conv.bias.double().expand(vox.shape).clone()
        mag = conv.bias.double().abs().expand(vox.shape).clone()
        for f, k0, k1 in groups:
            sampled = grid_sample_2d_quad_kernel(f, uv).double()
            ref += sampled @ kernel[k0:k1]
            mag += sampled.abs() @ kernel[k0:k1].abs()
    tol = (64 + 2) * 2.0 ** -24 * mag
    assert ((vox.double() - ref).abs() <= tol).all()
