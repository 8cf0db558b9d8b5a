"""The port's CUDA kernels on the card (marked ``cuda``; skips without a CUDA
device). Imports neither JAX nor the JAX package, so on a machine without
JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pytest
import torch

from hgsfusion_tpu_torch.models.layers import matmul_f32
from hgsfusion_tpu_torch.ops import quad_sample
from hgsfusion_tpu_torch.ops.grid_sample import grid_sample_2d_quad, quad_sample_bwd_plain
from hgsfusion_tpu_torch.ops.quad_sample import grid_sample_2d_quad_kernel, quad_indices

# bf16: the kernel sums in f32 and rounds once, the plain version rounds
# every product and sum (the JAX package's bf16 bound, 0.04); f32: order of
# four fused multiply-adds
TOLS = {torch.float32: 1e-5, torch.bfloat16: 0.04}
SHAPES = [(1, 9, 13, 64), (2, 7, 5, 192), (1, 6, 7, 5)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, shape, dtype, device):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(shape, generator=g).to(dtype)
    coords = torch.rand((shape[0], 10, 13, 2), generator=g) * 2.6 - 1.3
    return feats.to(device), coords.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(cuda, shape, dtype):
    f, c = _inputs(0, shape, dtype, cuda)
    before = quad_sample.launches[quad_sample.KERNEL]
    got = grid_sample_2d_quad_kernel(f, c)
    torch.cuda.synchronize()
    assert quad_sample.launches[quad_sample.KERNEL] == before + 1
    assert got.shape == c.shape[:-1] + (shape[-1],) and got.dtype == dtype
    ref = grid_sample_2d_quad(f.cpu(), c.cpu())
    torch.testing.assert_close(got.cpu().float(), ref.float(), rtol=0, atol=TOLS[dtype])


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    fp = torch.zeros((1, 4, 5, 8), device=cuda, dtype=torch.float64)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda)
    w4 = torch.zeros((3, 4), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        quad_sample.quad_sample_fwd(fp, idx, w4)
    with pytest.raises(TypeError, match="int32"):
        quad_sample.quad_sample_fwd(fp.float(), idx.long(), w4)
    with pytest.raises(ValueError, match="shapes"):
        quad_sample.quad_sample_fwd(fp.float(), idx, w4[:2])


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
    before = quad_sample.launches[quad_sample.BWD_KERNEL]
    got = quad_sample.quad_sample_bwd(ct, idx, w4, padded, bins)
    torch.cuda.synchronize()
    assert quad_sample.launches[quad_sample.BWD_KERNEL] == before + 1
    ct, idx, w4 = ct.cpu(), idx.cpu(), w4.cpu()
    ref = quad_sample_bwd_plain(ct, idx, w4, padded)
    assert got.shape == ref.shape and got.dtype == dtype
    if case == "contention":
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "hot"])
def test_backward_kernel_is_deterministic(cuda, case):
    """No atomics: two calls on the same input agree bit for bit."""
    ct, idx, w4, padded, bins = _bwd_inputs(case, 192, torch.bfloat16, cuda)
    first = quad_sample.quad_sample_bwd(ct, idx, w4, padded, bins)
    again = quad_sample.quad_sample_bwd(ct, idx, w4, padded, quad_sample.quad_bins(idx, w4, padded))
    assert torch.equal(first, again)


@pytest.mark.cuda
def test_autograd_reaches_the_backward_kernel(cuda):
    """A CUDA gradient builds the bins in the forward, launches
    quad_sample_bwd once and equals the plain backward's; the coordinates get
    none. A forward under inference_mode builds no bins."""
    f, c = _inputs(1, SHAPES[0], torch.float32, cuda)
    before = dict(quad_sample.launches)
    with torch.inference_mode():
        grid_sample_2d_quad_kernel(f, c)
    assert quad_sample.launches[quad_sample.BINS] == before[quad_sample.BINS]
    f.requires_grad_()
    c.requires_grad_()
    out = grid_sample_2d_quad_kernel(f, c)
    assert quad_sample.launches[quad_sample.BINS] == before[quad_sample.BINS] + 1
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)).to(cuda)
    (out * cot).sum().backward()
    assert quad_sample.launches[quad_sample.BWD_KERNEL] == before[quad_sample.BWD_KERNEL] + 1
    assert c.grad is None
    fc = f.detach().cpu().requires_grad_()
    (grid_sample_2d_quad_kernel(fc, c.detach().cpu()) * cot.cpu()).sum().backward()
    torch.testing.assert_close(f.grad.cpu(), fc.grad, rtol=0, atol=1e-5)


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
