"""The port's CUDA kernels on the card (marked ``cuda``; skips without a CUDA
device). Imports neither JAX nor the JAX package, so on a machine without
JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import (compare_instances, edge_coords, outside_coords, run_rhgm_tool,
                        sampling_route, unaligned)
from hgsfusion_tpu_torch.models.frustum import FrustumToVoxelMultiScale
from hgsfusion_tpu_torch.models.layers import matmul_f32
from hgsfusion_tpu_torch.ops import quad_sample, row_scatter
from hgsfusion_tpu_torch.ops.grid_sample import (grid_sample_2d_quad, quad_sample_bwd_plain,
                                                 quad_sample_fwd_plain)
from hgsfusion_tpu_torch.ops.quad_sample import grid_sample_2d_quad_kernel, quad_indices
from hgsfusion_tpu_torch.rhgm.mask2former import Mask2FormerInstance
from hgsfusion_tpu_torch.tools import generate_hybrid_points as ghp

# bf16: the kernel sums in f32 and rounds once, the plain version rounds
# every product and sum (the JAX package's bf16 bound, 0.04); f32: order of
# four fused multiply-adds
TOLS = {torch.float32: 1e-5, torch.bfloat16: 0.04}
# 64, 192 and 40 channels take 16-byte vectors, 5 and 13 the element path
SHAPES = [(1, 9, 13, 64), (2, 7, 5, 192), (1, 6, 7, 5), (2, 11, 17, 40), (2, 11, 17, 13)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, shape, dtype, device):
    """Features and coords (-1.3 .. 1.3): a (B, 10, 13, 2) view of a grid
    whose rows hold 3 floats, read in place as the view transform reads
    ``grid[..., 0:2]``."""
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(shape, generator=g).to(dtype)
    grid = torch.rand((shape[0], 10, 13, 3), generator=g) * 2.6 - 1.3
    return feats.to(device), grid.to(device)[..., 0:2]


def _check_fwd(f, coords):
    """One launch with idx/w4 and one without against the plain version:
    the output at TOLS, the same output both times, idx and w4 bit for bit;
    then the autograd entry, one more launch and the same output, and on
    CPU tensors no launch."""
    c = f.shape[-1]
    before = quad_sample.launches[quad_sample.KERNEL]
    out, idx, w4 = quad_sample.quad_sample_fwd(f, coords, taps=True)
    bare, no_idx, no_w4 = quad_sample.quad_sample_fwd(f, coords)
    torch.cuda.synchronize()
    assert quad_sample.launches[quad_sample.KERNEL] == before + 2
    assert no_idx is None and no_w4 is None
    ref, ref_idx, ref_w4 = quad_sample.quad_sample_fwd_uv_plain(f.cpu(), coords.cpu(), taps=True)
    assert out.shape == ref.shape == (coords[..., 0].numel(), c) and out.dtype == f.dtype
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=0, atol=TOLS[f.dtype])
    assert torch.equal(out, bare)
    assert torch.equal(idx.cpu(), ref_idx) and torch.equal(w4.cpu(), ref_w4)
    got = grid_sample_2d_quad_kernel(f, coords)
    assert quad_sample.launches[quad_sample.KERNEL] == before + 3
    assert got.shape == coords.shape[:-1] + (c,) and torch.equal(got.reshape(-1, c), out)
    grid_sample_2d_quad_kernel(f.cpu(), coords.cpu())
    assert quad_sample.launches[quad_sample.KERNEL] == before + 3
    return out, w4


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(cuda, shape, dtype, aligned):
    """The forward kernel on strided coords, B = 1 and 2, vector and
    element paths, and on a map whose data starts one element past a
    16-byte boundary (the element path)."""
    f, c = _inputs(0, shape, dtype, cuda)
    _check_fwd(f if aligned else unaligned(f), c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_edges_and_outside(cuda, dtype):
    """Coordinates on, beside and beyond every edge, and coordinates wholly
    outside the map: zero weights, an all-zero output."""
    g = torch.Generator().manual_seed(6)
    for shape in ((1, 5, 7, 8), (1, 1, 1, 8), (1, 9, 13, 64)):
        f = torch.randn(shape, generator=g).to(dtype).to(cuda)
        _check_fwd(f, edge_coords(cuda, shape[1:3]))
    f = torch.randn((2, 11, 17, 16), generator=g).to(dtype).to(cuda)
    out, w4 = _check_fwd(f, outside_coords(cuda))
    assert not bool(out.any()) and not bool(w4.any())


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    f, uv = _inputs(0, SHAPES[0], torch.float32, cuda)
    fwd = quad_sample.quad_sample_fwd
    with pytest.raises(TypeError, match="dtype"):
        fwd(f.double(), uv)
    with pytest.raises(TypeError, match="uv must be float32"):
        fwd(f, uv.double())
    with pytest.raises(ValueError, match="shapes features"):
        fwd(f[0], uv)
    with pytest.raises(ValueError, match="shapes uv"):
        fwd(f, uv.expand(2, -1, -1, -1))
    with pytest.raises(ValueError, match="one stride"):
        fwd(f, uv.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        fwd(f.transpose(1, 2), uv)
    with pytest.raises(ValueError, match="CUDA"):
        fwd(f.cpu(), uv.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        fwd(f, uv.cpu())
    # 2 x 32770 x 32770 padded pixels: past int32 (torch.empty writes nothing)
    big = torch.empty((2, 32768, 32768, 1), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        fwd(big, uv.expand(2, -1, -1, -1))
    del big


BWD_CASES = ["ragged", "contention", "hot"]
BWD_CHANNELS = [40, 64, 192, 3]


def _bwd_inputs(case, c, dtype, device):
    """(grad_out, idx, w4, padded shape, bins) of a ragged map with
    out-of-bounds coords; a contention case, every query on one 2x2 patch
    with weights 1/4 and small-integer cotangents, whose f32 sums are exact;
    or a hot case, 80% of the queries within 0.2 px of two pixels and the
    rest spread over the map and beyond it."""
    g = torch.Generator().manual_seed(3)
    if case == "ragged":
        shape = (2, 11, 17, c)
        coords = torch.rand((2, 37, 3, 2), generator=g) * 2.6 - 1.3
    elif case == "contention":
        shape = (1, 9, 9, c)
        coords = torch.full((1, 64, 64, 2), -0.375)  # pixel 2.5: the patch's center
    else:
        shape = (1, 20, 37, c)
        coords = torch.rand((1, 2000, 2), generator=g) * 2.6 - 1.3
        hot = torch.tensor([[-0.2, 0.1], [0.55, -0.6]])[torch.randint(0, 2, (1600,), generator=g)]
        coords[0, :1600] = hot + (torch.rand((1600, 2), generator=g) - 0.5) * 0.02
    feats = torch.zeros(shape, dtype=dtype)
    idx, w4 = quad_indices(feats, coords)
    n = idx.numel()
    if case == "contention":
        ct = torch.randint(-4, 5, (n, c), generator=g).float()
    else:
        ct = torch.randn((n, c), generator=g)
    b, h, w, _ = shape
    padded = (b, h + 2, w + 2, c)
    idx, w4 = idx.to(device), w4.to(device)
    return ct.to(dtype).to(device), idx, w4, padded, quad_sample.quad_bins(idx, w4, padded)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", BWD_CHANNELS)
@pytest.mark.parametrize("case", BWD_CASES)
def test_backward_kernel_matches_plain(cuda, case, c, dtype):
    """Both sum in f32 in another order and round once: f32 atol 1e-5 x
    (1 + max|ref|); bf16 one rounding, rtol 2^-7, plus the order bound of an
    f32 sum, n u S (n the pixel's contributions, S the sum of their
    magnitudes, u = 2^-24); contention exact."""
    ct, idx, w4, padded, bins = _bwd_inputs(case, c, dtype, cuda)
    _check_bwd(ct, idx, w4, padded, bins, exact=case == "contention")


def _check_bwd(ct, idx, w4, padded, bins, exact=False):
    """One launch of the backward kernel against its plain version: bit for
    bit when ``exact``, else at the tolerances above."""
    dtype = ct.dtype
    before = quad_sample.launches[quad_sample.BWD_KERNEL]
    got = quad_sample.quad_sample_bwd(ct, idx, w4, padded, bins)
    torch.cuda.synchronize()
    assert quad_sample.launches[quad_sample.BWD_KERNEL] == before + 1
    ct, idx, w4 = ct.cpu(), idx.cpu(), w4.cpu()
    ref = quad_sample_bwd_plain(ct, idx, w4, padded)
    assert got.shape == ref.shape and got.dtype == dtype
    if exact:
        assert torch.equal(got.cpu(), ref)
    elif dtype == torch.float32:
        atol = 1e-5 * (1 + float(ref.abs().max()))
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=atol)
    else:
        s_abs = quad_sample_bwd_plain(ct.float().abs(), idx, w4.abs(), padded)
        n_max = int(quad_sample_bwd_plain(torch.ones((idx.numel(), 1)), idx,
                                          (w4 != 0).float(), padded[:3] + (1,)).max())
        tol = 1e-6 + 2.0 ** -7 * ref.float().abs() + n_max * 2.0 ** -24 * s_abs
        assert bool(((got.cpu().float() - ref.float()).abs() <= tol).all())


# the polar view's sampled maps at 128 channels (the two reduced maps of the
# near field, the polar table of pass 3), a ragged polar-like map, and a
# map of 65,535 padded pixels (255 x 257), the last whose bins take 16-bit
# keys
POLAR_SHAPES = [(1, 129, 484, 128), (1, 65, 242, 128), (1, 128, 490, 128), (2, 13, 29, 128)]
LAST16_SHAPE = (1, 253, 255, 64)


def _polar_inputs(shape, dtype, device, n=6000):
    """Features, coords (most on the map, some beyond it, a fifth of them on
    a few hot pixels) and a cotangent."""
    g = torch.Generator().manual_seed(7)
    b, c = shape[0], shape[-1]
    coords = torch.rand((b, n, 2), generator=g) * 2.2 - 1.1
    coords[:, : n // 5] = (torch.rand((4, 2), generator=g) * 2 - 1)[
        torch.randint(0, 4, (n // 5,), generator=g)] + 0.003 * torch.rand((n // 5, 2), generator=g)
    feats = torch.randn(shape, generator=g).to(dtype)
    ct = torch.randn((b * n, c), generator=g).to(dtype)
    return feats.to(device), coords.to(device), ct.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", POLAR_SHAPES + [LAST16_SHAPE])
def test_kernels_match_plain_at_polar_shapes(cuda, shape, dtype):
    """Forward and backward (with its bins) against their plain versions."""
    f, coords, ct = _polar_inputs(shape, dtype, cuda)
    got = grid_sample_2d_quad_kernel(f, coords)
    torch.testing.assert_close(got.cpu().float(), grid_sample_2d_quad(f.cpu(), coords.cpu()).float(),
                               rtol=0, atol=TOLS[dtype])
    idx, w4 = quad_indices(f, coords)
    b, h, w, c = shape
    padded = (b, h + 2, w + 2, c)
    bins = quad_sample.quad_bins(idx, w4, padded)
    if shape == LAST16_SHAPE:  # the sentinel key is the largest int16
        assert b * (h + 2) * (w + 2) == 2**16 - 1
        order, start = (x.cpu().long() for x in bins)
        valid = (w4 != 0).any(dim=1).cpu()
        nv = int(start[-1])
        assert nv == int(valid.sum()) < idx.numel()
        assert torch.equal(torch.sort(idx.cpu().long()[order[:nv]]).values,
                           idx.cpu().long()[order[:nv]])
    _check_bwd(ct, idx, w4, padded, bins)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "hot"])
def test_backward_kernel_is_deterministic(cuda, case):
    """No atomics: two calls on the same input agree bit for bit."""
    ct, idx, w4, padded, bins = _bwd_inputs(case, 192, torch.bfloat16, cuda)
    first = quad_sample.quad_sample_bwd(ct, idx, w4, padded, bins)
    again = quad_sample.quad_sample_bwd(ct, idx, w4, padded, quad_sample.quad_bins(idx, w4, padded))
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_reaches_the_backward_kernel(cuda, dtype):
    """A CUDA gradient: the forward launches the kernel once, which writes
    idx/w4, and builds the bins from them; the backward launches
    quad_sample_bwd once, equals it fed ``quad_indices``' idx/w4 bit for bit
    and the plain backward's within the f32 order (bf16: one unit apart);
    the coordinates get none. A forward under inference_mode builds no
    bins."""
    f, grid_uv = _inputs(1, SHAPES[1], dtype, cuda)
    before = dict(quad_sample.launches)
    with torch.inference_mode():
        grid_sample_2d_quad_kernel(f, grid_uv)
    assert quad_sample.launches[quad_sample.BINS] == before[quad_sample.BINS]
    f.requires_grad_()
    c = grid_uv.detach().requires_grad_()
    out = grid_sample_2d_quad_kernel(f, c)
    assert quad_sample.launches[quad_sample.KERNEL] == before[quad_sample.KERNEL] + 2
    assert quad_sample.launches[quad_sample.BINS] == before[quad_sample.BINS] + 1
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)).to(dtype).to(cuda)
    (out * cot).float().sum().backward()
    assert quad_sample.launches[quad_sample.BWD_KERNEL] == before[quad_sample.BWD_KERNEL] + 1
    assert c.grad is None
    b, h, w, ch = f.shape
    padded = (b, h + 2, w + 2, ch)
    idx, w4 = quad_indices(f.detach(), grid_uv)
    want = quad_sample.quad_sample_bwd(cot.reshape(-1, ch).contiguous(), idx, w4, padded,
                                       quad_sample.quad_bins(idx, w4, padded))
    assert torch.equal(f.grad, want)
    fc = f.detach().cpu().requires_grad_()
    (grid_sample_2d_quad_kernel(fc, grid_uv.cpu()) * cot.cpu()).float().sum().backward()
    # both sum in f32 and round once: f32 order; bf16 also one unit apart
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(f.grad.cpu().float(), fc.grad.float(), rtol=rtol, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("k", [64, 192])
def test_matmul_f32_keeps_each_product_unrounded(cuda, k, dtype):
    """The f2v reduce's product on the card: half-precision operands, one
    f32-accumulating product. Forward: the f64 product of the same operands
    within f32 rounding of a (K + 1)-term sum; gradients: the f64 products
    of the f32 cotangent, rounded once to the operands' dtype."""
    g = torch.Generator().manual_seed(5)
    a = torch.randn((517, k), generator=g).to(dtype).to(cuda).requires_grad_()
    b = (0.25 * torch.randn((k, 128), generator=g)).to(dtype).to(cuda).requires_grad_()
    cot = torch.randn((517, 128), generator=g).to(cuda)
    out = matmul_f32(a, b)
    assert out.dtype == torch.float32 and type(out.grad_fn).__name__ == "_MatmulF32Backward"
    (out * cot).sum().backward()
    assert a.grad.dtype == dtype and b.grad.dtype == dtype
    u, half_u = 2.0 ** -24, {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}[dtype]
    a64, b64, c64 = a.detach().double(), b.detach().double(), cot.double()
    checks = (
        (out, a64 @ b64, a64.abs() @ b64.abs(), k, 0.0),
        (a.grad, c64 @ b64.t(), c64.abs() @ b64.abs().t(), 128, half_u),
        (b.grad, a64.t() @ c64, a64.abs().t() @ c64.abs(), 517, half_u),
    )
    for got, ref, mag, n, rnd in checks:
        tol = rnd * ref.abs() + (1 + rnd) * (n + 1) * u * mag
        assert bool(((got.double() - ref).abs() <= tol).all())


@pytest.mark.cuda
def test_backward_kernel_rejects_what_it_does_not_take(cuda):
    ct = torch.zeros((3, 8), device=cuda, dtype=torch.float64)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda)
    w4 = torch.zeros((3, 4), device=cuda)
    padded = (1, 4, 5, 8)
    order, start = quad_sample.quad_bins(idx, w4, padded)
    with pytest.raises(TypeError, match="dtype"):
        quad_sample.quad_sample_bwd(ct, idx, w4, padded, (order, start))
    with pytest.raises(ValueError, match="shapes"):
        quad_sample.quad_sample_bwd(ct.float(), idx, w4, (1, 4, 5, 6), (order, start))
    with pytest.raises(ValueError, match="CUDA"):
        quad_sample.quad_sample_bwd(ct.float().cpu(), idx.cpu(), w4.cpu(), padded,
                                    (order.cpu(), start.cpu()))
    # bad bins: wrong dtype, wrong length, on the CPU
    with pytest.raises(TypeError, match="int32"):
        quad_sample.quad_sample_bwd(ct.float(), idx, w4, padded, (order.long(), start))
    with pytest.raises(ValueError, match="shapes"):
        quad_sample.quad_sample_bwd(ct.float(), idx, w4, padded, (order, start[:-1]))
    with pytest.raises(ValueError, match="contiguous on"):
        quad_sample.quad_sample_bwd(ct.float(), idx, w4, padded, (order, start.cpu()))


# the fused sampler + reduce: (maps of the gather groups, outputs); the
# flagship's two groups at small maps, a ragged case (odd channels and
# outputs, three groups of two frames), one wider than a block's 128
# outputs, and two groups of one size (one tap computation)
REDUCE_CASES = {
    "two_groups": ([(1, 9, 13, 64), (1, 5, 7, 192)], 128),
    "ragged": ([(2, 11, 17, 13), (2, 6, 9, 37), (2, 3, 4, 5)], 45),
    "wide": ([(1, 7, 9, 24), (1, 4, 5, 40)], 200),
    "same_size": ([(1, 5, 7, 64), (1, 5, 7, 40), (1, 9, 13, 8)], 64),
}
HALF_U = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def _reduce_inputs(maps, o, dtype, device):
    """(uv, groups, kmat, bias) as FrustumToVoxelMultiScale.accumulate
    builds them: uv a (B, 10, 13, 2) view of a grid whose rows hold 3
    floats, 130 queries per frame (not a multiple of a tile)."""
    g = torch.Generator().manual_seed(8)
    grid = torch.rand((maps[0][0], 10, 13, 3), generator=g) * 2.6 - 1.3
    groups, off = [], 0
    for shape in maps:
        groups.append((torch.randn(shape, generator=g).to(dtype).to(device), off))
        off += shape[-1]
    kmat = (torch.randn((off, o), generator=g) * off ** -0.5).to(dtype).to(device)
    return grid.to(device)[..., 0:2], groups, kmat, torch.randn(o, generator=g).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", list(REDUCE_CASES))
def test_reduce_kernel_matches_plain(cuda, case, dtype):
    """One launch against the plain version, output in the compute dtype.
    Both sum the products in f32 in another order: 1e-5 x (1 + max|ref|) in
    f32. In half precision the plain version rounds after each of the taps'
    4 products and 3 sums, the kernel once, so 8 roundings of the taps'
    magnitude S through |K| are allowed, 8 u (S @ |K|), and each rounds its
    output once, 2 u |ref|; the sampling route with the kernel's rounding
    (chip_smoke.sampling_route: quad_sample_fwd + matmul_f32), rounded
    once, is held at 1e-4 x (1 + max|ref|) + 2 u |ref|."""
    uv, groups, kmat, bias = _reduce_inputs(*REDUCE_CASES[case], dtype, cuda)
    before = dict(quad_sample.launches)
    got = quad_sample.quad_sample_reduce_fwd(uv, groups, kmat, bias)
    torch.cuda.synchronize()
    assert quad_sample.launches[quad_sample.REDUCE_KERNEL] == before[quad_sample.REDUCE_KERNEL] + 1
    assert quad_sample.launches[quad_sample.KERNEL] == before[quad_sample.KERNEL]
    cpu = [(f.cpu(), k) for f, k in groups]
    ref = quad_sample.quad_sample_reduce_plain(uv.cpu(), cpu, kmat.cpu(), bias.cpu())
    assert got.shape == ref.shape and got.dtype == ref.dtype == dtype
    ref = ref.float()
    scale = 1 + float(ref.abs().max())
    err = (got.cpu().float() - ref).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5 * scale
        return
    u = HALF_U[dtype]
    mag = 0
    for f, k in cpu:
        idx, w4 = quad_indices(f, uv.cpu())
        fp = F.pad(f, (0, 0, 1, 1, 1, 1))
        mag = mag + (quad_sample_fwd_plain(fp.float().abs(), idx, w4.abs())
                     @ kmat.cpu()[k:k + f.shape[-1]].float().abs())
    assert bool((err <= 1e-4 * scale + 8 * u * mag + 2 * u * ref.abs()).all())
    same = sampling_route(uv, groups, kmat, bias)
    assert bool(((got.float() - same.to(dtype).float()).abs()
                 <= 1e-4 * scale + 2 * u * same.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(1, 5, 7, 8), (2, 9, 13, 8), (1, 1, 1, 8)])
def test_taps_match_quad_indices(cuda, shape, dtype):
    """The fused kernel's own tap computation (``quad_sample_taps``) against
    ``quad_indices`` on the card and on the CPU, bit for bit, at coordinates
    on, beside and beyond every edge, read in place from a strided grid."""
    feats = torch.zeros(shape, dtype=dtype, device=cuda)
    coords = edge_coords(cuda, (5, 7, 9, 13)).expand(shape[0], -1, -1)
    grid = torch.cat([coords, torch.zeros_like(coords[..., :1])], dim=-1).contiguous()
    uv = grid[..., 0:2]
    idx, w4 = quad_sample.quad_sample_taps(feats, uv)
    torch.cuda.synchronize()
    want_idx, want_w4 = quad_indices(feats, uv)
    assert torch.equal(idx, want_idx) and torch.equal(w4, want_w4)
    cpu_idx, cpu_w4 = quad_indices(feats.cpu(), uv.cpu())
    assert torch.equal(idx.cpu(), cpu_idx) and torch.equal(w4.cpu(), cpu_w4)


@pytest.mark.cuda
def test_reduce_kernel_rejects_what_it_does_not_take(cuda):
    uv, groups, kmat, bias = _reduce_inputs(*REDUCE_CASES["two_groups"], torch.bfloat16, cuda)
    fwd = quad_sample.quad_sample_reduce_fwd
    with pytest.raises(ValueError, match="groups"):
        fwd(uv, groups * 3, kmat, bias)
    with pytest.raises(TypeError, match="differ"):
        fwd(uv, groups, kmat.float(), bias)
    with pytest.raises(TypeError, match="float32"):
        fwd(uv, groups, kmat, bias.double())
    with pytest.raises(TypeError, match="uv must be float32"):
        fwd(uv.double(), groups, kmat, bias)
    with pytest.raises(ValueError, match="shapes"):
        fwd(uv, groups, kmat[:100], bias)
    with pytest.raises(ValueError, match="shapes uv"):
        fwd(uv.expand(2, -1, -1, -1), groups, kmat, bias)
    with pytest.raises(ValueError, match="one stride"):
        fwd(uv.transpose(1, 2), groups, kmat, bias)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(uv, groups, kmat.t().contiguous().t(), bias)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(uv, [(f.transpose(1, 2), k) for f, k in groups], kmat, bias)
    with pytest.raises(ValueError, match="CUDA"):
        fwd(uv.cpu(), [(f.cpu(), k) for f, k in groups], kmat.cpu(), bias.cpu())
    # a K slice wider than a block's shared memory holds
    big = [(torch.zeros((1, 5, 7, 512), dtype=torch.bfloat16, device=cuda), 0)]
    with pytest.raises(ValueError, match="shared memory"):
        fwd(uv, big, torch.zeros((512, 128), dtype=torch.bfloat16, device=cuda), bias)
    # f32 reads K in chunks: no such limit
    out = fwd(uv, [(big[0][0].float(), 0)], torch.zeros((512, 128), device=cuda), bias)
    torch.cuda.synchronize()
    assert torch.equal(out, bias.expand_as(out))


@pytest.mark.cuda
def test_view_transform_routes(cuda):
    """FrustumToVoxelMultiScale on the card: under inference_mode one fused
    launch for the two groups and no sampler launch, in bf16; with gradients
    one sampler launch per group, its bins, and no fused launch, in f32; the
    two agree within 1e-4 of the largest output plus the fused route's one
    rounding to bf16."""
    g = torch.Generator().manual_seed(9)
    feats = [torch.randn((1, 9, 13, 16), generator=g)] + [
        torch.randn((1, 5, 7, 16), generator=g) for _ in range(3)]
    feats = [f.to(cuda).requires_grad_() for f in feats]
    grid = (torch.rand((1, 6, 7, 5, 3), generator=g) * 2.4 - 1.2).to(cuda)
    f2v = FrustumToVoxelMultiScale([16] * 4, 24, dtype=torch.bfloat16).to(cuda).eval()
    before = dict(quad_sample.launches)
    with torch.inference_mode():
        fused = f2v.accumulate(feats, grid)
    torch.cuda.synchronize()
    mid = dict(quad_sample.launches)
    assert {k: mid[k] - before[k] for k in mid} == {
        quad_sample.KERNEL: 0, quad_sample.REDUCE_KERNEL: 1, quad_sample.TAPS: 0,
        quad_sample.BWD_KERNEL: 0, quad_sample.BINS: 0}
    sampled = f2v.accumulate(feats, grid)
    after = dict(quad_sample.launches)
    assert {k: after[k] - mid[k] for k in mid} == {
        quad_sample.KERNEL: 2, quad_sample.REDUCE_KERNEL: 0, quad_sample.TAPS: 0,
        quad_sample.BWD_KERNEL: 0, quad_sample.BINS: 2}
    assert fused.dtype == torch.bfloat16 and sampled.dtype == torch.float32
    sampled = sampled.detach()
    scale = float(sampled.abs().max())
    assert bool(((fused.float() - sampled).abs() <= 1e-4 * scale + 2.0 ** -8 * sampled.abs())
                .all())


# row_scatter_add: (updates, table rows, channels, index mode)
SCATTER_CASES = {"windowed": (4096, 300, 256, "window"), "odd_c": (3000, 257, 37, "ragged"),
                 "one_row": (20000, 64, 24, "one_row"), "f32_wide": (5000, 100, 129, "ragged")}


def _scatter_inputs(case, dtype, device, integer):
    """(idx, rows, num_rows): windowed indices as the benchmark draws them;
    a ragged mix with negative and out-of-range indices; or every update on
    one row. Integer-valued rows sum exactly in f32 in any order."""
    n, p, c, mode = SCATTER_CASES[case]
    g = torch.Generator().manual_seed(11)
    if mode == "window":
        base = torch.randint(0, p - 64 + 1, (n // 64, 1), generator=g)
        idx = (base + torch.randint(0, 64, (n // 64, 64), generator=g)).reshape(-1)
    elif mode == "ragged":
        idx = torch.randint(-p - 20, p + 20, (n,), generator=g)
    else:
        idx = torch.full((n,), 5)
    rows = (torch.randint(-3, 4, (n, c), generator=g).float() if integer
            else torch.randn((n, c), generator=g))
    return idx.to(torch.int32).to(device), rows.to(dtype).to(device), p


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_row_scatter_kernel_matches_plain(cuda, case, dtype, integer):
    """Integer-valued rows: bit for bit. Random rows: both sum in f32 in
    another order and round once, so one rounding of the dtype (2 u |ref|)
    plus the f32 order bound (k u_f32 S, k the most updates of a row, S the
    row's sum of |rows|)."""
    idx, rows, p = _scatter_inputs(case, dtype, cuda, integer)
    before = row_scatter.launches[row_scatter.KERNEL]
    got = row_scatter.row_scatter_add(idx, rows, p)
    torch.cuda.synchronize()
    assert row_scatter.launches[row_scatter.KERNEL] == before + 1
    assert got.shape == (p, rows.shape[1]) and got.dtype == dtype
    ref = row_scatter.row_scatter_add_plain(idx.cpu(), rows.cpu(), p)
    assert torch.equal(row_scatter.row_scatter_add(idx, rows, p), got)  # deterministic
    if integer:
        assert torch.equal(got.cpu(), ref)
        return
    u = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}[dtype]
    s_abs = row_scatter.row_scatter_add_plain(idx.cpu(), rows.cpu().float().abs(), p)
    k = int(row_scatter.row_scatter_bins(idx.cpu(), p)[1].diff().max())
    tol = 1e-6 + 2 * u * ref.float().abs() + k * 2.0 ** -24 * s_abs
    assert bool(((got.cpu().float() - ref.float()).abs() <= tol).all())


@pytest.mark.cuda
def test_row_scatter_kernel_rejects_what_it_does_not_take(cuda):
    idx = torch.zeros(3, dtype=torch.int32, device=cuda)
    rows = torch.zeros((3, 8), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        row_scatter.row_scatter_add(idx, rows.double(), 4)
    with pytest.raises(TypeError, match="int32 or int64"):
        row_scatter.row_scatter_add(idx.float(), rows, 4)
    with pytest.raises(ValueError, match="shapes"):
        row_scatter.row_scatter_add(idx[:2], rows, 4)
    with pytest.raises(ValueError, match="CUDA"):
        row_scatter.row_scatter_add_kernel(rows.cpu(), row_scatter.row_scatter_bins(idx, 4), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("pixel_decoder", ["msdeform", "fpn"])
def test_segmentor_card_matches_cpu(cuda, pixel_decoder):
    """The tiny segmentor, weights from one seed, on a 45 x 61 image: logits
    within 1e-4 of the CPU's in f32, instances by ``compare_instances``."""
    kw = dict(pixel_decoder=pixel_decoder, seed=2, **ghp.PRESETS["tiny"])
    img = torch.rand((1, 45, 61, 3), generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        ref = Mask2FormerInstance(device="cpu", **kw)(img)
        got = Mask2FormerInstance(device=cuda, **kw)(img.to(cuda))
    for k in ref:
        torch.testing.assert_close(got[k].cpu(), ref[k], rtol=0, atol=1e-4)
    compare_instances(ref, got, (45, 61))


@pytest.mark.cuda
def test_rhgm_tool_on_card(cuda, tmp_path):
    """The tool's model source on the card (tiny preset, a 64 x 96 tree):
    points in every frame, no kernel launched, and the precomputed source
    on its masks writes the same files."""
    from hgsfusion_tpu_torch.datasets.synthetic import make_synthetic_kitti

    root = make_synthetic_kitti(tmp_path / "vod", num_frames=2, num_points=256,
                                image_hw=(64, 96), structured=True)
    common = ["--data_root", str(root), "--image_hw", "64", "96", "--num_virtual", "30",
              "--confidence_threshold", "0.0"]
    res, captured = run_rhgm_tool(cuda, common + [
        "--model_preset", "tiny", "--resize_shortest", "80", "--device", str(cuda),
        "--pts_save_path", str(tmp_path / "model")], capture=True)
    assert all(f["virtual"] > 0 for f in res["frames"])
    (tmp_path / "masks").mkdir()
    for idx, (masks, labels) in zip(ghp.frame_ids(root, "train"), captured["masks"]):
        np.savez(tmp_path / "masks" / f"{idx}.npz", masks=masks, labels=labels)
    run_rhgm_tool(cuda, common + ["--mask_source", "precomputed", "--masks_dir",
                                  str(tmp_path / "masks"), "--pts_save_path",
                                  str(tmp_path / "pre")], capture=False)
    for f in (tmp_path / "model").iterdir():
        assert f.read_bytes() == (tmp_path / "pre" / f.name).read_bytes(), f.name
