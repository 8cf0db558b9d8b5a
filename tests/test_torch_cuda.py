"""The port's CUDA kernels on the card (marked ``cuda``; skips without a CUDA
device). Imports neither JAX nor the JAX package, so on a machine without
JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import (PARTA2_POOL, TINY, check_nms_frame, check_nms_mask, clustered_boxes,
                        compare_instances, degenerate_boxes, edge_coords, hot_pixel_grid,
                        outside_coords, output_digest, parent_activation_scale,
                        parta2_pool_inputs, plain_nms_batch, reduce_q8_ragged, run_rhgm_tool,
                        sampling_route, tiny_batch, unaligned, w8a8_input)
from hgsfusion_tpu_torch.models.detector import HGSFusionModel, post_process
from hgsfusion_tpu_torch.models.frustum import FrustumToVoxelMultiScale
from hgsfusion_tpu_torch.ops import conv_int8, depth_sample, library, nms, quad_sample, row_scatter
from hgsfusion_tpu_torch.ops.matmul import matmul_f32
from hgsfusion_tpu_torch.ops.grid_sample import (grid_sample_2d_quad, quad_sample_bwd_plain,
                                                 quad_sample_fwd_plain, quantize_per_channel_int8)
from hgsfusion_tpu_torch.ops.quad_sample import grid_sample_2d_quad_kernel, quad_indices
from hgsfusion_tpu_torch.ops.roiaware_pool import roiaware_pool3d
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
    before = library.launches[library.KERNEL]
    out, idx, w4 = library.quad_sample_fwd(f, coords, taps=True)
    bare, no_idx, no_w4 = library.quad_sample_fwd(f, coords)
    torch.cuda.synchronize()
    assert library.launches[library.KERNEL] == before + 2
    assert no_idx is None and no_w4 is None
    ref, ref_idx, ref_w4 = quad_sample.quad_sample_fwd_uv_plain(f.cpu(), coords.cpu(), taps=True)
    assert out.shape == ref.shape == (coords[..., 0].numel(), c) and out.dtype == f.dtype
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=0, atol=TOLS[f.dtype])
    assert torch.equal(out, bare)
    assert torch.equal(idx.cpu(), ref_idx) and torch.equal(w4.cpu(), ref_w4)
    got = grid_sample_2d_quad_kernel(f, coords)
    assert library.launches[library.KERNEL] == before + 3
    assert got.shape == coords.shape[:-1] + (c,) and torch.equal(got.reshape(-1, c), out)
    grid_sample_2d_quad_kernel(f.cpu(), coords.cpu())
    assert library.launches[library.KERNEL] == before + 3
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
    fwd = library.quad_sample_fwd
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
    before = library.launches[library.BWD_KERNEL]
    got = library.quad_sample_bwd(ct, idx, w4, padded, bins)
    torch.cuda.synchronize()
    assert library.launches[library.BWD_KERNEL] == before + 1
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
    first = library.quad_sample_bwd(ct, idx, w4, padded, bins)
    again = library.quad_sample_bwd(ct, idx, w4, padded, quad_sample.quad_bins(idx, w4, padded))
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
    before = dict(library.launches)
    with torch.inference_mode():
        grid_sample_2d_quad_kernel(f, grid_uv)
    assert library.launches[library.BINS] == before[library.BINS]
    f.requires_grad_()
    c = grid_uv.detach().requires_grad_()
    out = grid_sample_2d_quad_kernel(f, c)
    assert library.launches[library.KERNEL] == before[library.KERNEL] + 2
    assert library.launches[library.BINS] == before[library.BINS] + 1
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)).to(dtype).to(cuda)
    (out * cot).float().sum().backward()
    assert library.launches[library.BWD_KERNEL] == before[library.BWD_KERNEL] + 1
    assert c.grad is None
    b, h, w, ch = f.shape
    padded = (b, h + 2, w + 2, ch)
    idx, w4 = quad_indices(f.detach(), grid_uv)
    want = library.quad_sample_bwd(cot.reshape(-1, ch).contiguous(), idx, w4, padded,
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
        library.quad_sample_bwd(ct, idx, w4, padded, (order, start))
    with pytest.raises(ValueError, match="shapes"):
        library.quad_sample_bwd(ct.float(), idx, w4, (1, 4, 5, 6), (order, start))
    with pytest.raises(ValueError, match="CUDA"):
        library.quad_sample_bwd(ct.float().cpu(), idx.cpu(), w4.cpu(), padded,
                                    (order.cpu(), start.cpu()))
    # bad bins: wrong dtype, wrong length, on the CPU
    with pytest.raises(TypeError, match="int32"):
        library.quad_sample_bwd(ct.float(), idx, w4, padded, (order.long(), start))
    with pytest.raises(ValueError, match="shapes"):
        library.quad_sample_bwd(ct.float(), idx, w4, padded, (order, start[:-1]))
    with pytest.raises(ValueError, match="contiguous on"):
        library.quad_sample_bwd(ct.float(), idx, w4, padded, (order, start.cpu()))


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
    before = dict(library.launches)
    got = library.quad_sample_reduce_fwd(uv, groups, kmat, bias)
    torch.cuda.synchronize()
    assert library.launches[library.REDUCE_KERNEL] == before[library.REDUCE_KERNEL] + 1
    assert library.launches[library.KERNEL] == before[library.KERNEL]
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
    idx, w4 = library.quad_sample_taps(feats, uv)
    torch.cuda.synchronize()
    want_idx, want_w4 = quad_indices(feats, uv)
    assert torch.equal(idx, want_idx) and torch.equal(w4, want_w4)
    cpu_idx, cpu_w4 = quad_indices(feats.cpu(), uv.cpu())
    assert torch.equal(idx.cpu(), cpu_idx) and torch.equal(w4.cpu(), cpu_w4)


@pytest.mark.cuda
def test_reduce_kernel_rejects_what_it_does_not_take(cuda):
    uv, groups, kmat, bias = _reduce_inputs(*REDUCE_CASES["two_groups"], torch.bfloat16, cuda)
    fwd = library.quad_sample_reduce_fwd
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
    before = dict(library.launches)
    with torch.inference_mode():
        fused = f2v.accumulate(feats, grid)
    torch.cuda.synchronize()
    mid = dict(library.launches)
    assert {k: mid[k] - before[k] for k in mid} == {
        library.KERNEL: 0, library.REDUCE_KERNEL: 1, library.TAPS: 0,
        library.BWD_KERNEL: 0, library.BINS: 0, library.NMS_MASK: 0, library.NMS_SWEEP: 0,
        library.DEPTH_KERNEL: 0, library.DEPTH_BWD_KERNEL: 0, library.Q8_KERNEL: 0,
        library.REDUCE_Q8_KERNEL: 0, library.CONV_W8A8: 0, library.QUANTIZE_INT8: 0,
        library.FPS: 0}
    sampled = f2v.accumulate(feats, grid)
    after = dict(library.launches)
    assert {k: after[k] - mid[k] for k in mid} == {
        library.KERNEL: 2, library.REDUCE_KERNEL: 0, library.TAPS: 0,
        library.BWD_KERNEL: 0, library.BINS: 2, library.NMS_MASK: 0, library.NMS_SWEEP: 0,
        library.DEPTH_KERNEL: 0, library.DEPTH_BWD_KERNEL: 0, library.Q8_KERNEL: 0,
        library.REDUCE_Q8_KERNEL: 0, library.CONV_W8A8: 0, library.QUANTIZE_INT8: 0,
        library.FPS: 0}
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


def _nms_case(name):
    """(boxes (B, K, 7), valid (B, K), max_keep) at the configs' 4,096
    candidates (37 for "ragged", 3,001 for "odd_k", 8,192 for "k8192")."""
    rng = np.random.RandomState(21)
    k = {"ragged": 37, "odd_k": 3001, "k8192": 8192}.get(name, 4096)
    allv = np.ones((1, k), bool)
    boxes = clustered_boxes(k, max(k // 5, 1), 0)[None]
    if name == "realistic":
        return boxes, np.arange(k)[None] < 64, 500
    if name == "batch2":
        return (np.stack([clustered_boxes(k, 800, 1), clustered_boxes(k, 1600, 2)]),
                np.stack([rng.rand(k) < 0.5, np.ones(k, bool)]), 500)
    if name == "degenerate":
        return degenerate_boxes(k, 3)[None], allv, 500
    if name == "none_valid":
        return boxes, ~allv, 500
    if name == "max_keep":
        return boxes, allv, 37
    if name == "odd_k":
        return boxes, rng.rand(1, k) < 0.7, 500
    return boxes, allv, 500  # "worst", "ragged", "k8192"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["worst", "realistic", "batch2", "degenerate", "none_valid",
                                  "max_keep", "ragged", "odd_k", "k8192"])
def test_nms_kernel_matches_plain(cuda, case):
    """One mask and one sweep launch for the batch; every keep decision
    follows the greedy rule with the plain IoU given the kernels' own
    earlier decisions (a difference only at an IoU within 1e-5 of the
    threshold), so the keep sets equal the plain version's unless such a
    tie occurs; the mask's bits equal ``nms_mask_plain``'s where the sweep
    reads them up to such ties, and the sweep equals ``nms_sweep_plain`` on
    the kernel's own mask."""
    boxes, valid, max_keep = _nms_case(case)
    b = torch.from_numpy(np.ascontiguousarray(boxes)).to(cuda)
    v = torch.from_numpy(np.ascontiguousarray(valid)).to(cuda)
    before = dict(library.launches)
    got = library.nms_lazy_op(b, v, 0.01, max_keep)
    moved = {k: library.launches[k] - before[k] for k in before}
    assert {k: v for k, v in moved.items() if v} == {library.NMS_MASK: 1, library.NMS_SWEEP: 1}
    assert got.dtype == torch.bool and got.shape == v.shape
    ties = sum(check_nms_frame(b[i], v[i], got[i], 0.01, max_keep)["tie_decisions"]
               for i in range(b.shape[0]))
    want = plain_nms_batch(b, v, 0.01, max_keep)
    assert torch.equal(got, want) or ties > 0
    assert torch.equal(library.nms_lazy_op(b, v, 0.01, max_keep), got)  # deterministic
    mask = library.nms_mask(b, v, 0.01)
    for i in range(b.shape[0]):
        check_nms_mask(b[i], v[i], mask[i], 0.01)  # raises on a bit off the plain mask
        assert torch.equal(nms.nms_sweep_plain(mask[i], v[i], max_keep), got[i])


@pytest.mark.cuda
def test_nms_kernel_rejects_what_it_does_not_take(cuda):
    """Wrong devices and strides raise; 8,192 candidates (which one block's
    shared memory no longer bounds) equal the plain version; a mask past
    int32 indexing raises."""
    boxes, valid, _ = _nms_case("ragged")
    b = torch.from_numpy(boxes).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    with pytest.raises(ValueError, match="CUDA"):
        library.nms_lazy(b.cpu(), v.cpu(), 0.01, 5)
    with pytest.raises(ValueError, match="contiguous"):
        library.nms_lazy(b[:, ::2], v[:, ::2].contiguous(), 0.01, 5)
    with pytest.raises(ValueError, match="on"):
        library.nms_lazy(b, v.cpu(), 0.01, 5)
    big = torch.zeros((1, 8192, 7), device=cuda)
    ones = torch.ones((1, 8192), dtype=torch.bool, device=cuda)
    keep = library.nms_lazy_op(big, ones, 0.1, 5)
    assert torch.equal(keep, plain_nms_batch(big, ones, 0.1, 5)) and int(keep.sum()) == 5
    huge = torch.zeros((1, 2**19, 7), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        library.nms_lazy_op(huge, torch.ones((1, 2**19), dtype=torch.bool, device=cuda), 0.1, 5)


@pytest.mark.cuda
def test_post_process_makes_no_host_read(cuda):
    """The TINY model's post-process with every candidate valid runs with
    each host-synchronizing call an error, and equals the CPU's on
    tie-broken scores."""
    model = HGSFusionModel(TINY, device=cuda, seed=5)
    with torch.inference_mode():
        preds = model(model.batch_to_device(tiny_batch()))
        cls = preds["cls_preds"]
        preds["cls_preds"] = cls + torch.linspace(0, 0.1, cls.numel(), device=cuda).view(cls.shape)
        kw = dict(score_thresh=0.0, nms_thresh=0.01, pre_max_size=512, post_max_size=100)
        post_process(preds, model.anchors, model.box_coder, TINY, **kw)  # warm-up
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = post_process(preds, model.anchors, model.box_coder, TINY, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        cpu = {k: v.cpu() for k, v in preds.items()}
        want = post_process(cpu, model.anchors.cpu(), model.box_coder, TINY, **kw)
    assert torch.equal(got["valid"].cpu(), want["valid"]) and bool(want["valid"].any())
    v = want["valid"]
    torch.testing.assert_close(got["boxes"].cpu()[v], want["boxes"][v], rtol=1e-5, atol=1e-5)


# the depth-weighted sampler (csrc/quad_sample_depth.cu): maps with 16, 80,
# 33 and 128 depth bins; 64 and 192 channels take 16-byte vectors in the
# forward and channel pairs in the backward, 5 and 13 the element paths
DEPTH_SHAPES = [((1, 9, 13, 64), 16), ((2, 7, 5, 192), 80), ((1, 6, 7, 5), 33),
                ((2, 11, 17, 13), 128)]


def _depth_inputs(seed, shape, d, dtype, device):
    """A map, its distribution over d bins (a softmax over d + 1 without the
    last, in the map's dtype) and a contiguous (B, 10, 13, 3) grid whose
    (u, v) and depth leave the map and the bins (-1.3 .. 1.3)."""
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(shape, generator=g).to(dtype)
    probs = torch.softmax(2 * torch.randn(shape[:3] + (d + 1,), generator=g), -1)[..., :d]
    grid = torch.rand((shape[0], 10, 13, 3), generator=g) * 2.6 - 1.3
    return feats.to(device), probs.to(dtype).contiguous().to(device), grid.to(device)


def _depth_bwd_tol(ct, feats, grid, d, ref):
    """The probabilities' gradient is summed in f32 in both versions, in
    another order: 1e-5 (1 + max|ref|), plus n u S, S the sum of the
    magnitudes of an element's terms and n their number (a pixel's
    contributions plus the channels of a dot product)."""
    s_abs = depth_sample.quad_sample_depth_bwd_plain(ct.float().abs(), feats.float().abs(),
                                                     grid, d)
    n = grid[..., 0].numel() * 4 + feats.shape[-1]
    return 1e-5 * (1 + float(ref.abs().max())) + n * 2.0 ** -24 * s_abs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,d", DEPTH_SHAPES)
def test_depth_kernels_match_plain(cuda, shape, d, dtype):
    """The forward (with and without its keys and effective weights) against
    its plain version at TOLS, the keys bit for bit, the weights to f32
    rounding; the probabilities' gradient against its plain version and
    bit for bit from call to call; one launch each."""
    f, p, grid = _depth_inputs(0, shape, d, dtype, cuda)
    before = dict(library.launches)
    out, key, we = library.quad_sample_depth_fwd(f, p, grid, taps=True)
    bare = library.quad_sample_depth_fwd(f, p, grid)[0]
    torch.cuda.synchronize()
    assert library.launches[library.DEPTH_KERNEL] == before[library.DEPTH_KERNEL] + 2
    ref, ref_key, ref_we = depth_sample.quad_sample_depth_fwd_plain(f.cpu(), p.cpu(), grid.cpu(),
                                                                    taps=True)
    assert out.dtype == dtype and torch.equal(out, bare)
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=0, atol=TOLS[dtype])
    assert torch.equal(key.cpu(), ref_key)
    torch.testing.assert_close(we.cpu(), ref_we, rtol=1e-6, atol=1e-7)
    b, h, w, c = shape
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(dtype).to(cuda)
    bins = depth_sample.depth_bins(key, (b, h + 2, w + 2, c))
    got = library.quad_sample_depth_bwd(ct, f, grid, d, bins)
    again = library.quad_sample_depth_bwd(ct, f, grid, d, bins)
    torch.cuda.synchronize()
    assert library.launches[library.DEPTH_BWD_KERNEL] == before[library.DEPTH_BWD_KERNEL] + 2
    assert got.shape == (b, h, w, d) and got.dtype == torch.float32 and torch.equal(got, again)
    want = depth_sample.quad_sample_depth_bwd_plain(ct.cpu(), f.cpu(), grid.cpu(), d)
    tol = _depth_bwd_tol(ct.cpu(), f.cpu(), grid.cpu(), d, want)
    assert bool(((got.cpu() - want).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depth_backward_contention_is_exact(cuda, dtype):
    """Every query on one pixel (its 2x2 patch, weights of 1/4) at bin
    centres (weights 1 and 0), small-integer maps and cotangents: the sums
    are exact in any order, so the kernel's gradient equals the plain
    version's bit for bit."""
    b, h, w, c, d = 1, 6, 9, 24, 17  # (w - 1, d - 1) powers of 2: exact coordinates
    g = torch.Generator().manual_seed(3)
    feats = torch.randint(-3, 4, (b, h, w, c), generator=g).to(dtype)
    probs = torch.full((b, h, w, d), 0.5).to(dtype)
    n = 4096
    u = 2 * 3.5 / (w - 1) - 1  # between columns 3 and 4
    v = 2 * 2.5 / (h - 1) - 1  # between rows 2 and 3
    z = 2 * torch.randint(0, d, (n,), generator=g).float() / (d - 1) - 1  # bin centres
    grid = torch.stack([torch.full((n,), u), torch.full((n,), v), z], -1).view(1, n, 3)
    ct = torch.randint(-4, 5, (n, c), generator=g).to(dtype)
    f, p, gr, ctc = (x.to(cuda) for x in (feats, probs, grid, ct))
    _, key, _ = library.quad_sample_depth_fwd(f, p, gr, taps=True)
    got = library.quad_sample_depth_bwd(ctc, f, gr, d, depth_sample.depth_bins(key, (b, h + 2,
                                                                                   w + 2, c)))
    want = depth_sample.quad_sample_depth_bwd_plain(ct, feats, grid, d)
    assert torch.equal(got.cpu(), want) and bool(want.any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depth_backward_heavy_pixel(cuda, dtype):
    """Most of 6,000 queries on one pixel, random values: the pixels of its
    taps carry more entry visits than one chunk of phase 2 holds, so their
    chunks are summed by the last pass; against the plain version within
    its order bound, and bit for bit from call to call."""
    f, p, _ = _depth_inputs(6, (1, 9, 13, 64), 80, dtype, cuda)
    g = torch.Generator().manual_seed(7)
    n = 6000
    grid = hot_pixel_grid(cuda, g, n)
    _, key, _ = library.quad_sample_depth_fwd(f, p, grid, taps=True)
    bins = depth_sample.depth_bins(key, (1, 11, 15, 64))
    assert int((bins[1][1:] - bins[1][:-1]).max()) > 4 * 256
    ct = torch.randn((n, 64), generator=g).to(dtype).to(cuda)
    got = library.quad_sample_depth_bwd(ct, f, grid, 80, bins)
    again = library.quad_sample_depth_bwd(ct, f, grid, 80, bins)
    assert torch.equal(got, again)
    want = depth_sample.quad_sample_depth_bwd_plain(ct.cpu(), f.cpu(), grid.cpu(), 80)
    tol = _depth_bwd_tol(ct.cpu(), f.cpu(), grid.cpu(), 80, want)
    assert bool(((got.cpu() - want).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depth_route_gradients_match_cpu(cuda, dtype):
    """The autograd entry on the card (the forward with keys and weights,
    the bins, quad_sample_bwd for the map and quad_sample_depth_bwd for the
    distribution) against the same entry on the CPU (plain versions)."""
    f, p, grid = _depth_inputs(4, (2, 7, 5, 192), 80, dtype, cuda)
    ct = torch.randn(grid.shape[:-1] + (192,), generator=torch.Generator().manual_seed(5))
    grads = []
    for dev in (cuda, "cpu"):
        fg, pg = f.to(dev).detach().requires_grad_(), p.to(dev).detach().requires_grad_()
        before = dict(library.launches)
        depth_sample.grid_sample_depth_kernel(fg, pg, grid.to(dev)).backward(ct.to(dev, dtype))
        moved = {k: library.launches[k] - before[k] for k in before}
        grads.append((fg.grad.cpu().float(), pg.grad.cpu().float(), moved))
    (gf, gp, moved), (rf, rp, cpu_moved) = grads
    assert not any(cpu_moved.values())
    assert {k: v for k, v in moved.items() if v} == {
        library.DEPTH_KERNEL: 1, library.BINS: 1, library.BWD_KERNEL: 1,
        library.DEPTH_BWD_KERNEL: 1}
    tol = 1e-5 if dtype == torch.float32 else 0.05
    torch.testing.assert_close(gf, rf, rtol=0, atol=tol * (1 + float(rf.abs().max())))
    torch.testing.assert_close(gp, rp, rtol=0, atol=tol * (1 + float(rp.abs().max())))


@pytest.mark.cuda
def test_depth_kernels_reject_what_they_do_not_take(cuda):
    f, p, grid = _depth_inputs(6, (1, 9, 13, 64), 16, torch.bfloat16, cuda)
    with pytest.raises(TypeError, match="differ"):
        library.quad_sample_depth_fwd(f, p.float(), grid)
    with pytest.raises(ValueError, match="depth bins"):
        library.quad_sample_depth_fwd(f, torch.zeros(f.shape[:3] + (129,), dtype=f.dtype,
                                                     device=cuda), grid)
    with pytest.raises(ValueError, match="CUDA"):
        library.quad_sample_depth_fwd(f.cpu(), p.cpu(), grid.cpu())
    with pytest.raises(ValueError, match="grid"):
        library.quad_sample_depth_fwd(f, p, grid[..., 0:2])
    with pytest.raises(ValueError, match="contiguous"):
        library.quad_sample_depth_fwd(f, p.transpose(1, 2).contiguous().transpose(1, 2), grid)
    out, key, _ = library.quad_sample_depth_fwd(f, p, grid, taps=True)
    bins = depth_sample.depth_bins(key, (1, 11, 15, 64))
    with pytest.raises(ValueError, match="grad_out"):
        library.quad_sample_depth_bwd(out.float(), f, grid, 16, bins)
    with pytest.raises(TypeError, match="int32"):
        library.quad_sample_depth_bwd(out, f, grid, 16, (bins[0].long(), bins[1]))


# -- F2V QUANT int8 and DDN QUANT w8a8 ----------------------------------------

def _q8_tol(q, idx, w4, ref, out, dtype):
    """1e-5 of the taps' magnitude S = sum |w q| (the f32 sums' order), and in
    half precision one ulp of each output more (both round once)."""
    mag = quad_sample_fwd_plain(F.pad(q.float().abs(), (0, 0, 1, 1, 1, 1)), idx, w4.abs())
    tol = 1e-5 * mag
    if dtype != torch.float32:
        m, e = torch.frexp(torch.maximum(ref.float().abs(), out.float().abs()))
        tol = tol + torch.where(m == 0, torch.zeros_like(m),
                                torch.ldexp(torch.ones_like(m), e - (8 if dtype == torch.bfloat16
                                                                     else 11)))
    return tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", SHAPES)
def test_q8_kernel_matches_plain(cuda, shape, dtype):
    """``quad_sample_fwd`` on an int8 map (K1-q8) against
    ``quad_sample_q8_plain``: the output at ``_q8_tol``, idx and w4 bit for
    bit, one launch counted; the autograd entry's gradient equals K2 on the
    cotangent over the scales (straight-through)."""
    feats, coords = _inputs(11, shape, torch.float32, cuda)
    q, scale = quantize_per_channel_int8(feats)
    before = library.launches[library.Q8_KERNEL]
    out, idx, w4 = library.quad_sample_fwd(q, coords, taps=True, dtype=dtype)
    torch.cuda.synchronize()
    assert library.launches[library.Q8_KERNEL] == before + 1
    ref, ref_idx, ref_w4 = quad_sample.quad_sample_q8_plain(q.cpu(), coords.cpu(), dtype,
                                                             taps=True)
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.equal(idx.cpu(), ref_idx) and torch.equal(w4.cpu(), ref_w4)
    err = (out.cpu().float() - ref.float()).abs()
    assert bool((err <= _q8_tol(q.cpu(), ref_idx, ref_w4, ref, out.cpu(), dtype)).all())
    x = feats.detach().requires_grad_()
    got, s = quad_sample.grid_sample_2d_quad_q8_kernel(x, coords, dtype)
    ct = torch.randn(got.shape, device=cuda).to(dtype)
    got.backward(ct)
    bins = quad_sample.quad_bins(idx, w4, (shape[0], shape[1] + 2, shape[2] + 2, shape[3]))
    want = library.quad_sample_bwd((ct / s.to(dtype)).reshape(-1, shape[3]).contiguous(), idx,
                                   w4, (shape[0], shape[1] + 2, shape[2] + 2, shape[3]), bins)
    assert torch.equal(x.grad, want.float())


REDUCE_Q8_CASES = {"two_groups": ([(1, 9, 13, 64), (1, 5, 7, 192)], 128),
                   "ragged": ([(2, 7, 9, 40), (2, 7, 9, 24), (2, 4, 5, 16)], 72),
                   "element_path": ([(1, 6, 7, 20)], 130)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", list(REDUCE_Q8_CASES))
def test_reduce_q8_kernel_matches_plain(cuda, case, dtype):
    """``quad_sample_reduce_q8_fwd`` against ``quad_sample_reduce_q8_plain``
    on int8 maps with the scales folded into K: f32 within 1e-5 x (1 +
    max|ref|); half precision within that, 1e-5 (S @ |K|) for the samples'
    f32 order and one unit of their rounding (u (S @ |K|)), and 2 u |ref|
    for the output's rounding."""
    maps, o = REDUCE_Q8_CASES[case]
    uv, groups, kmat, bias = _reduce_inputs(maps, o, torch.float32, cuda)
    qs = [quantize_per_channel_int8(f) for f, _ in groups]
    kq = (kmat * torch.cat([sc for _, sc in qs])[:, None]).to(dtype).contiguous()
    qgroups = [(q, k) for (q, _), (_, k) in zip(qs, groups)]
    before = dict(library.launches)
    got = library.quad_sample_reduce_q8_fwd(uv, qgroups, kq, bias)
    torch.cuda.synchronize()
    assert library.launches[library.REDUCE_Q8_KERNEL] == before[library.REDUCE_Q8_KERNEL] + 1
    cpu = [(q.cpu(), k) for q, k in qgroups]
    ref = quad_sample.quad_sample_reduce_q8_plain(uv.cpu(), cpu, kq.cpu(), bias.cpu())
    assert got.shape == ref.shape and got.dtype == ref.dtype == dtype
    ref = ref.float()
    scale = 1 + float(ref.abs().max())
    err = (got.cpu().float() - ref).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5 * scale
        return
    u = HALF_U[dtype]
    mag = 0
    for q, k in cpu:
        idx, w4 = quad_indices(q, uv.cpu(), dtype)
        mag = mag + (quad_sample_fwd_plain(F.pad(q.float().abs(), (0, 0, 1, 1, 1, 1)), idx,
                                           w4.abs()) @ kq.cpu()[k:k + q.shape[-1]].float().abs())
    assert bool((err <= 1e-5 * scale + (1e-5 + u) * mag + 2 * u * ref.abs()).all())


# sha256 of P3-q8's output on chip_smoke.reduce_q8_ragged, recorded on an
# NVIDIA H100 80GB HBM3 from the kernel before its int8 combine lost the I2F
# conversions and its products overlapped the next chunk (commit 8e5f2e8):
# the redesign keeps every rounding and each output's chunk and k16 order,
# so the bits stay (compare_kernels_parent.py prints both trees' digests)
Q8_RAGGED_SHA256 = {
    torch.bfloat16: "0d3ec6a83a0f91f7ac76cf897ead0cc1ce8309186025bdbcb76b588467e6598f",
    torch.float16: "b73085bcab93727a9a139a2eed0e8d824996ab0329a5107549e9758aa6bdb9ee"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_reduce_q8_kernel_bit_for_bit_to_its_parent(cuda, dtype):
    uv, groups, kmat, bias = reduce_q8_ragged(cuda, dtype)
    got = library.quad_sample_reduce_q8_fwd(uv, groups, kmat, bias)
    assert got.dtype == dtype and got.shape == (260, 72)
    assert output_digest(got) == Q8_RAGGED_SHA256[dtype]


CONV_CASES = [((1, 21, 33, 3), 64, 7, 2, 3, 1), ((2, 9, 11, 64), 96, 1, 1, 0, 1),
              ((1, 13, 15, 64), 64, 3, 2, 1, 1), ((1, 10, 12, 128), 136, 3, 1, 2, 2),
              ((1, 10, 12, 256), 256, 3, 1, 4, 4), ((2, 7, 9, 48), 37, 3, 2, 2, 2),
              ((1, 6, 5, 20), 24, 3, 1, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,o,k,s,p,d", CONV_CASES)
def test_conv_w8a8_kernel_is_exact(cuda, shape, o, k, s, p, d, dtype):
    """``conv2d_w8a8`` on a float input it quantizes itself, equal to its
    plain version (the int32 sum is exact) at the backbone's kinds of
    convolution and ragged ones (odd outputs, 3 and 20 channels: int8 im2col
    rows), every tile width among the cases, with the input's own scale
    (2^-4: exact midpoints, ties to even) and with a small random one
    (clipped levels), the launches counted; its first pass alone
    (``quantize_int8``, or ``im2col_int8`` for channels not a multiple of
    16) equal to its plain version; ``activation_scale`` on the card bit
    for bit the parent's formula (``abs``, ``amax``, the exact division) on
    an input whose largest |x| is not special; and the op
    ``hgsfusion::conv2d_w8a8`` through ``qconv2d`` equal on the card and the
    CPU."""
    g = torch.Generator().manual_seed(12)
    x = w8a8_input(shape, g, "cpu").to(dtype)
    qw = torch.randint(-127, 128, (o, shape[-1], k, k), generator=g, dtype=torch.int8)
    wt = conv_int8.pack_weight(qw)
    wk = torch.rand(o, generator=g)
    conv_args = ((k, k), (s, s), (p, p), (d, d))
    args = conv_args + (dtype,)
    ax = conv_int8.activation_scale(x)
    assert float(ax) == 2.0 ** -4
    for scale in (ax, torch.rand(1, generator=g) * 0.02):
        want = conv_int8.conv2d_w8a8_plain(x, wt, scale, wk, *args)
        before = dict(library.launches)
        got = library.conv2d_w8a8(x.to(cuda), wt.to(cuda), scale.to(cuda), wk.to(cuda), *args)
        torch.cuda.synchronize()
        assert library.launches[library.CONV_W8A8] == before[library.CONV_W8A8] + 1
        assert library.launches[library.QUANTIZE_INT8] == before[library.QUANTIZE_INT8] + 1
        assert torch.equal(got.cpu(), want), scale
        if shape[-1] % 16 == 0:
            q = library.quantize_int8(x.to(cuda), scale.to(cuda))
            assert torch.equal(q.cpu(), conv_int8.quantize(x, scale))
        else:
            rows = library.im2col_int8(x.to(cuda), scale.to(cuda), *conv_args, wt.shape[1])
            assert torch.equal(rows.cpu(), conv_int8.im2col_plain(
                conv_int8.quantize(x, scale), *conv_args, wt.shape[1]))
    xg = (torch.randn(shape, generator=g) * 3).to(dtype).to(cuda)
    assert torch.equal(conv_int8.activation_scale(xg), parent_activation_scale(xg))
    conv = torch.nn.Conv2d(shape[-1], o, k, s, p, d, bias=False)
    xf = torch.randn(shape, generator=g)
    assert torch.equal(conv_int8.qconv2d(xf.to(cuda), conv.to(cuda), dtype).cpu(),
                       conv_int8.qconv2d(xf, conv.cpu(), dtype))


@pytest.mark.cuda
def test_deform_conv_card_matches_cpu(cuda):
    """The parallel ASPP's deformable branch with random offsets (taps
    between pixels and outside the map): output and the gradients of the
    input, the weights and ``conv_offset`` on the card against the CPU."""
    from hgsfusion_tpu_torch.ops.deform_conv import ModulatedDeformConv2d
    torch.manual_seed(3)
    cpu = ModulatedDeformConv2d(16, 12, 3, dilation=6)
    with torch.no_grad():
        cpu.conv_offset.weight.normal_(0.0, 0.05)
        cpu.conv_offset.bias.normal_(0.0, 0.5)
    card = ModulatedDeformConv2d(16, 12, 3, dilation=6).to(cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 19, 23, 16)
    xs = [x.clone().requires_grad_(), x.to(cuda).requires_grad_()]
    outs = [m(v) for m, v in zip((cpu, card), xs)]
    ct = torch.randn(outs[0].shape)
    for o, c in zip(outs, (ct, ct.to(cuda))):
        (o * c).sum().backward()
    scale = float(outs[0].abs().max())
    assert float((outs[1].cpu() - outs[0]).abs().max()) <= 1e-5 * scale
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        assert float((q.grad.cpu() - p.grad).abs().max()) <= 1e-4 * float(p.grad.abs().max()), name
    assert float((xs[1].grad.cpu() - xs[0].grad).abs().max()) <= 1e-4 * float(xs[0].grad.abs().max())


@pytest.mark.cuda
def test_multihead_post_process_stacks_its_sets_into_one_nms(cuda):
    """The TINY multi-head PointPillars model (``chip_smoke.tiny_zoo``):
    its post-process launches one mask and one sweep for the batch's 20
    (frame, class) sets, makes no host read, and keeps in each set what
    the NMS op keeps for that set alone (one launch pair a set)."""
    from chip_smoke import tiny_zoo, zoo_model

    cfg, batch, seed, lift = tiny_zoo("PointPillar")
    model = zoo_model("PointPillar", cfg, cuda, seed, lift)
    with torch.inference_mode():
        preds = model(model.batch_to_device(batch))
        before = dict(library.launches)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = model.post_process(preds)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        moved = {k: library.launches[k] - before[k] for k in before}
        assert {k: v for k, v in moved.items() if v} == {library.NMS_MASK: 1,
                                                         library.NMS_SWEEP: 1}
        from hgsfusion_tpu_torch.models.detector import multihead_candidate_sets
        scores, boxes, _ = multihead_candidate_sets(preds, model.anchors, model.box_coder, cfg)
        post = cfg.nms_post_max_size
        for si, (s, b) in enumerate(zip(scores, boxes)):
            idx, valid = nms.class_agnostic_nms(s, b[..., :7], cfg.score_thresh, cfg.nms_thresh,
                                                cfg.nms_pre_max_size, post)
            block = slice(si * post, (si + 1) * post)
            assert torch.equal(got["valid"][:, block], valid)
            want = torch.take_along_dim(b[..., :7], idx[..., None], dim=1)
            assert torch.equal(got["boxes"][:, block][valid], want[valid])


# FPS cases: (B, N, k, what): point 0 invalid, k above the valid points,
# none valid, exact ties, N = 1, N not a multiple of a block's 2,048 points
# (a cluster of 5, the last block ragged; named for the shared-memory variant
# of the one-block kernel it first tested), k = 0, exact ties whose equal
# points sit in every block of a cluster of 4, the only valid points at the
# highest indices, B=3 at 8,192 points, 32,768 (a cluster of 16) and the
# largest frame (16 blocks of 4,096 points)
FPS_CASES = [(3, 300, 64, "point0_invalid"), (2, 500, 400, "short"), (1, 200, 10, "none_valid"),
             (2, 640, 100, "ties"), (1, 1, 5, "single"), (1, 9000, 256, "shared_xyz"),
             (2, 100, 0, "k0"), (2, 8192, 200, "ties_across_blocks"),
             (1, 8192, 64, "valid_at_end"), (3, 8192, 128, "b3"), (1, 32768, 128, "cluster16"),
             (1, library.FPS_MAX_POINTS, 64, "limit")]
# (N, cluster, pts) launched through the C entry with a plan of its own:
# fewer points than blocks (the later blocks empty), two points a thread
# over 16 blocks, a frame on two blocks of 4,096 points
FPS_FORCED_PLANS = [(5, 8, 1), (3000, 16, 2), (8192, 2, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,what", FPS_CASES)
def test_fps_kernel_equals_plain(cuda, b, n, k, what):
    """``hgsfusion::farthest_point_sample`` on the card: the plain loop's
    indices exactly, one counted launch a batch (at k = 0 the C entry
    returns at once), and N above the kernel's limit refused."""
    from hgsfusion_tpu_torch.ops import pointnet2
    g = torch.Generator().manual_seed(n + k)
    xyz = torch.rand((b, n, 3), generator=g) * 40 - 20
    valid = torch.rand((b, n), generator=g) > 0.3
    if what == "point0_invalid":
        valid[:, 0] = False
    elif what == "short":
        valid[:, 100:] = False
    elif what == "none_valid":
        valid[:] = False
    elif what == "ties":
        xyz = xyz[:, :64].repeat(1, 10, 1)[:, torch.randperm(n, generator=g)]
    elif what == "ties_across_blocks":
        xyz = xyz[:, :64].repeat(1, n // 64, 1)
    elif what == "valid_at_end":
        valid[:, :n - 100] = False
    xyz, valid = xyz.to(cuda).contiguous(), valid.to(cuda)
    before = library.launches[library.FPS]
    got = pointnet2.farthest_point_sample(xyz, valid, k)
    assert library.launches[library.FPS] == before + 1
    assert got.shape == (b, k) and got.dtype == torch.int64
    assert torch.equal(got, pointnet2.farthest_point_sample_plain(xyz, valid, k))
    over = library.FPS_MAX_POINTS + 1
    with pytest.raises(ValueError, match=f"at most {library.FPS_MAX_POINTS}"):
        library.farthest_point_sample(torch.zeros((1, over, 3), device=cuda),
                                      torch.ones((1, over), dtype=torch.bool, device=cuda), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,cluster,pts", FPS_FORCED_PLANS)
def test_fps_kernel_forced_plans(cuda, n, cluster, pts):
    """The FPS kernel's C entry under a cluster size and points a thread
    that ``fps_plan`` would not pick, the plain loop's indices exactly; a
    plan that does not cover the frame refused."""
    from hgsfusion_tpu_torch.ops import pointnet2
    g = torch.Generator().manual_seed(n)
    xyz = (torch.rand((2, n, 3), generator=g) * 40 - 20).to(cuda)
    valid = (torch.rand((2, n), generator=g) > 0.2).to(cuda)
    k = min(n + 3, 100)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((2, k), dtype=torch.int64, device=cuda)
    fps = library.entry(library.FPS)
    assert fps(xyz.data_ptr(), valid.data_ptr(), 2, n, k, cluster, pts, out.data_ptr(),
               stream) == 0
    assert torch.equal(out, pointnet2.farthest_point_sample_plain(xyz, valid, k))
    assert fps(xyz.data_ptr(), valid.data_ptr(), 2, n, k, cluster, pts // 2 if pts > 1 else 3,
               out.data_ptr(), stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["max", "avg"])
def test_roiaware_pool_full_shapes_on_the_card(cuda, method):
    """Part-A2's RoI-aware pools at full shapes (128 RoIs over 8,192 points,
    6^3 cells; the max over 16 point features that tie within a voxel, the
    mean over the 4 part features): two card runs equal bit for bit, the
    CPU within f32 rounding (the max equal); the max pool's gradient too
    (two runs bit for bit, the CPU within 1e-6 of its largest)."""
    rois, xyz, valid, feats, part_feats = parta2_pool_inputs()
    f = feats if method == "max" else part_feats
    ct = torch.randn((1, 128) + (PARTA2_POOL,) * 3 + (f.shape[-1],),
                     generator=torch.Generator().manual_seed(0))

    def run(device):
        x = f.to(device).requires_grad_()
        out = roiaware_pool3d(rois.to(device), xyz.to(device), x, valid.to(device),
                              PARTA2_POOL, method)
        out.backward(ct.to(device))
        return out.detach().cpu(), x.grad.cpu()

    (a, ga), (b, gb), (ref, gref) = run(cuda), run(cuda), run("cpu")
    assert torch.equal(a, b) and torch.equal(ga, gb)
    assert (ref != 0).any(-1).sum() > 100
    if method == "max":
        assert torch.equal(a, ref)
    else:
        torch.testing.assert_close(a, ref, rtol=0, atol=1e-6 * float(ref.abs().max()))
    torch.testing.assert_close(ga, gref, rtol=0, atol=1e-6 * float(gref.abs().max()))

