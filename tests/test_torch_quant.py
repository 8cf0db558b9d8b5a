"""F2V QUANT int8 and DDN QUANT w8a8 of the PyTorch port against the JAX
package, on the CPU: the per-channel int8 quantization and QConv8 bit for
bit, the int8-payload sample and its straight-through gradient, the f2v
module under int8 in eval and train mode, the nested-gather merge and a
TINY w8a8 backbone (the TINY detectors: ``test_torch_quant_detector.py``).

The port's int8 sample sums the exact products of the int8 values and the
weights in f32 and rounds once to the compute dtype; JAX rounds after each
product and sum in bf16 (``_q8_sample_impl``). So in f32 the two agree up to
the order of the sum (1e-5 relative), and in bf16 within 8 roundings (JAX's
4 products and 3 sums, the port's one) of at most 2^-8 of the taps'
magnitude S = sum |w q|: 2^-5 S (the measured worst is printed: 0.46 of
it)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from hgsfusion_tpu.models.frustum import FrustumToVoxelMultiScale as JaxF2V
from hgsfusion_tpu.models.frustum import merge_nested_groups as jax_merge
from hgsfusion_tpu.models.resnet import QConv8
from hgsfusion_tpu.models.resnet import ResNetDeepLabBackbone as JaxBackbone
from hgsfusion_tpu.ops.grid_sample import grid_sample_2d_quad, grid_sample_2d_quad_q8
from hgsfusion_tpu.ops.grid_sample import quantize_per_channel_int8 as jax_quantize
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.models.frustum import FrustumToVoxelMultiScale, merge_nested_groups
from hgsfusion_tpu_torch.models.resnet import ResNetDeepLabBackbone
from hgsfusion_tpu_torch.ops import conv_int8
from hgsfusion_tpu_torch.ops.grid_sample import quantize_per_channel_int8
from hgsfusion_tpu_torch.ops.quad_sample import grid_sample_2d_quad_q8_kernel, quad_indices
from test_model import TINY
from torch_parity import assert_close, load, one_torch_thread, perturb_variables, t  # noqa: F401

KEY = jax.random.PRNGKey(0)
RTOL = 1e-5
# module-level train-mode tolerance (test_torch_train_modules.py)
TRAIN_TOL = 2e-5
TINY_Q8 = dataclasses.replace(TINY, f2v_sampler_kernel="xla", f2v_quant="int8")
TINY_W8 = dataclasses.replace(TINY_Q8, ddn_quant="w8a8")
# head outputs (test_torch_detector.py)
HEAD_TOL = 1e-4


def _coords(rng, b, n, lo=-1.2, hi=1.2):
    return rng.uniform(lo, hi, (b, n, 2)).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 6, 8, 4), (2, 9, 13, 24)])
def test_quantize_per_channel_is_bit_for_bit(shape):
    rng = np.random.RandomState(0)
    f = (rng.randn(*shape) * rng.uniform(0.1, 10, shape[-1])).astype(np.float32)
    f[..., 0] = 0.0  # an all-zero channel takes the 1e-12 floor
    q, scale = quantize_per_channel_int8(t(f))
    q_ref, scale_ref = jax_quantize(jnp.asarray(f))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(scale_ref))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_q8_sample_matches_jax(dtype):
    rng = np.random.RandomState(1)
    b, h, w, c = 2, 7, 9, 16
    f = rng.randn(b, h, w, c).astype(np.float32)
    coords = _coords(rng, b, 300)
    out_ref, scale_ref = grid_sample_2d_quad_q8(jnp.asarray(f), jnp.asarray(coords), dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    out, scale = grid_sample_2d_quad_q8_kernel(t(f), t(coords), tdt)
    assert out.dtype == tdt and out.shape == out_ref.shape
    np.testing.assert_array_equal(scale.numpy(), np.asarray(scale_ref))
    ref = np.asarray(out_ref.astype(jnp.float32))
    if dtype == jnp.float32:
        assert_close(out, ref, atol=RTOL, rtol=RTOL)
        return
    # bf16: within 2^-5 of the taps' magnitude S = sum |w q|
    q, _ = quantize_per_channel_int8(t(f))
    idx, w4 = quad_indices(q, t(coords), tdt)
    qp = torch.nn.functional.pad(q.float().abs(), (0, 0, 1, 1, 1, 1)).reshape(-1, c)
    i, wp2 = idx.long(), w + 2
    mag = sum(qp[i + off] * w4[:, k:k + 1].abs()
              for k, off in enumerate((0, 1, wp2, wp2 + 1))).reshape(ref.shape)
    diff = np.abs(out.float().numpy() - ref)
    print(f"q8 sample bf16: max |port - jax| {diff.max():.4g}, over 2^-5 S "
          f"{(diff / (2.0 ** -5 * mag.numpy() + 1e-30)).max():.3g}")
    assert (diff <= 2.0 ** -5 * mag.numpy()).all()


def test_q8_straight_through_gradient_matches_jax():
    """As tests/test_ops.py's: the gradient of (q8 sample * scale) is the
    exact sampler's, here both frameworks' against JAX's exact one."""
    rng = np.random.RandomState(2)
    b, h, w, c = 1, 6, 8, 4
    f = rng.randn(b, h, w, c).astype(np.float32)
    coords = _coords(rng, b, 9)
    ct = rng.randn(b, 9, c).astype(np.float32)

    def loss_exact(x):
        return jnp.sum(grid_sample_2d_quad(x, jnp.asarray(coords)) * ct)

    def loss_q8(x):
        out, scale = grid_sample_2d_quad_q8(x, jnp.asarray(coords), jnp.float32)
        return jnp.sum(out * jax.lax.stop_gradient(scale) * ct)

    g_ex = np.asarray(jax.grad(loss_exact)(jnp.asarray(f)))
    g_q8 = np.asarray(jax.grad(loss_q8)(jnp.asarray(f)))
    x = t(f).requires_grad_()
    out, scale = grid_sample_2d_quad_q8_kernel(x, t(coords), torch.float32)
    assert not scale.requires_grad
    (out * scale * t(ct)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), g_ex, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), g_q8, atol=1e-5)


def _f2v_inputs(rng, fine=(9, 13), coarse=(5, 7), c=16):
    feats = [rng.randn(1, *fine, c).astype(np.float32)] + [
        rng.randn(1, *coarse, c).astype(np.float32) for _ in range(3)]
    grid = rng.uniform(-1.2, 1.2, (1, 6, 7, 5, 3)).astype(np.float32)
    return feats, grid


@pytest.mark.parametrize("merge", [False, True])
def test_f2v_int8_eval_matches_jax(merge):
    rng = np.random.RandomState(3)
    feats, grid = _f2v_inputs(rng)
    jmod = JaxF2V(out_channels=24, quant="int8", merge_nested_gather=merge)
    v = perturb_variables(jmod.init(KEY, feats, grid, False), seed=4)
    ref = np.asarray(jmod.apply(v, feats, grid, False))
    port = load(FrustumToVoxelMultiScale([16] * 4, 24, quant="int8", sampler_kernel="xla",
                                         merge_nested_gather=merge),
                weights.frustum_to_voxel(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = port([t(a) for a in feats], t(grid))
    assert_close(got, ref, atol=RTOL * float(np.abs(ref).max()), rtol=RTOL)


@pytest.mark.parametrize("remat", [False, True])
def test_f2v_int8_train_matches_jax(remat):
    """Train mode: outputs, BN statistics and the gradients of the maps and
    the reduce kernel (straight-through) against ``jax.vjp``."""
    rng = np.random.RandomState(5)
    feats, grid = _f2v_inputs(rng)
    jmod = JaxF2V(out_channels=24, quant="int8")
    v = perturb_variables(jmod.init(KEY, feats, grid, False), seed=6)

    def fwd(params, fs):
        out, new = jmod.apply({"params": params, "batch_stats": v["batch_stats"]}, fs, grid,
                              True, mutable=["batch_stats"])
        return out, new["batch_stats"]

    out, vjp_fn, new_stats = jax.vjp(fwd, v["params"], [jnp.asarray(a) for a in feats],
                                     has_aux=True)
    cot = rng.randn(*out.shape).astype(np.float32)
    g_params, g_feats = vjp_fn(jnp.asarray(cot))

    port = FrustumToVoxelMultiScale([16] * 4, 24, quant="int8", sampler_kernel="xla",
                                    remat=remat)
    port.load_state_dict(weights.frustum_to_voxel(v["params"], v["batch_stats"]))
    port.train()
    xs = [t(a).requires_grad_() for a in feats]
    got = port(xs, t(grid))
    assert_close(got, out, atol=TRAIN_TOL * float(np.abs(np.asarray(out)).max()),
                 rtol=TRAIN_TOL)
    (got * t(cot)).sum().backward()
    state = weights.frustum_to_voxel(v["params"], jax.tree_util.tree_map(np.asarray, new_stats))
    for k in ("channel_reduce.1.running_mean", "channel_reduce.1.running_var"):
        assert_close(port.state_dict()[k], state[k], atol=1e-6, rtol=1e-5, err_msg=k)
    ref_grads = weights.frustum_to_voxel(g_params, v["batch_stats"])
    scale = max(float(np.abs(ref_grads[k].numpy()).max()) for k in ("channel_reduce.0.weight",
                                                                       "channel_reduce.0.bias"))
    for k, p in port.named_parameters():
        assert_close(p.grad, ref_grads[k], atol=TRAIN_TOL * scale, rtol=TRAIN_TOL, err_msg=k)
    for x, r in zip(xs, g_feats):
        assert_close(x.grad, r, atol=TRAIN_TOL * float(np.abs(np.asarray(r)).max()),
                     rtol=TRAIN_TOL)


@pytest.mark.parametrize("fine,coarse,nest", [((9, 13), (5, 7), True),
                                              ((9, 14), (5, 7), False)])
def test_merge_nested_groups(fine, coarse, nest):
    """The canvas and the remapped (u, v) equal JAX's on a nesting shape; a
    non-nesting one (VoD's: 483 != 2 x 241) leaves the two groups, so the
    module's output is the unmerged one exactly."""
    rng = np.random.RandomState(7)
    ff = rng.randn(1, *fine, 8).astype(np.float32)
    fc = rng.randn(1, *coarse, 24).astype(np.float32)
    feats, grid = _f2v_inputs(rng, fine, coarse, 8)
    port = FrustumToVoxelMultiScale([8] * 4, 24, sampler_kernel="xla").eval()
    merged = FrustumToVoxelMultiScale([8] * 4, 24, sampler_kernel="xla",
                                      merge_nested_gather=True).eval()
    merged.load_state_dict(port.state_dict())
    with torch.no_grad():
        plain = port([t(a) for a in feats], t(grid))
        got = merged([t(a) for a in feats], t(grid))
    if not nest:
        with pytest.raises(ValueError):
            merge_nested_groups(t(ff), t(fc))
        assert torch.equal(got, plain)
        return
    canvas, remap = merge_nested_groups(t(ff), t(fc))
    canvas_ref, remap_ref = jax_merge(jnp.asarray(ff), jnp.asarray(fc))
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(canvas_ref))
    uv = grid[..., 0:2]
    np.testing.assert_array_equal(remap(t(uv)).numpy(), np.asarray(remap_ref(jnp.asarray(uv))))
    # exact algebra: the merged gather reproduces the two groups' samples
    assert_close(got, plain.numpy(), atol=1e-4 * float(plain.abs().max()))


# every distinct (kernel, stride, dilation) of the VoD backbone
QCONV_CASES = [(3, 7, 2, 3, 1), (16, 1, 1, 0, 1), (16, 3, 1, 1, 1), (16, 3, 2, 1, 1),
               (16, 1, 2, 0, 1), (16, 3, 1, 2, 2), (16, 3, 1, 4, 4)]


@pytest.mark.parametrize("cin,k,s,p,d", QCONV_CASES)
def test_qconv8_is_bit_for_bit(cin, k, s, p, d):
    rng = np.random.RandomState(8)
    x = (rng.randn(2, 13, 15, cin) * 3).astype(np.float32)
    jmod = QConv8(24, (k, k), (s, s), ((p, p), (p, p)), (d, d))
    v = jmod.init(KEY, jnp.asarray(x))
    conv = nn.Conv2d(cin, 24, k, s, p, d, bias=False)
    conv.load_state_dict(weights.conv(v["params"]))
    for jdt, tdt in ((None, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(QConv8(24, (k, k), (s, s), ((p, p), (p, p)), (d, d), dtype=jdt).apply(
            v, jnp.asarray(x)).astype(jnp.float32))
        got = conv_int8.qconv2d(t(x), conv, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), ref)
        # the plain version of the kernel, on x with its one-pass scale
        q, wk = conv_int8.quantize_weight(conv.weight)
        plain = conv_int8.conv2d_w8a8_plain(t(x), conv_int8.pack_weight(q),
                                            conv_int8.activation_scale(t(x)), wk, (k, k), (s, s),
                                            (p, p), (d, d), tdt)
        np.testing.assert_array_equal(plain.float().numpy(), ref)


def _midpoint_input(rng, shape):
    """Normal values within 127 / 16, that largest |x| once, and one element
    in 8 on an exact rounding midpoint (k + 1/2) / 16: ax is 2^-4 exactly
    (in f32 and bf16), so x / ax is k + 1/2 and rounds to even."""
    x = np.clip(rng.randn(*shape) * 2, -7.9, 7.9)
    mid = rng.rand(*shape) < 1 / 8
    x = np.where(mid, (rng.randint(-127, 127, shape) + 0.5) / 16, x).astype(np.float32)
    x.reshape(-1)[0] = 127 / 16
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,k,s,p,d", [(16, 1, 1, 0, 1), (16, 3, 1, 2, 2)])
def test_qconv8_midpoints_are_bit_for_bit(cin, k, s, p, d, dtype):
    """Inputs on exact rounding midpoints of the scale: ``qconv2d`` and the
    kernel's plain version bit for bit JAX's ``QConv8``, x in the compute
    dtype (ties to even on both sides)."""
    x = _midpoint_input(np.random.RandomState(13), (1, 11, 12, cin))
    jdt, tdt = (None, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    xj = jnp.asarray(x) if jdt is None else jnp.asarray(x).astype(jnp.bfloat16)
    jmod = QConv8(24, (k, k), (s, s), ((p, p), (p, p)), (d, d), dtype=jdt)
    v = jmod.init(KEY, xj)
    ref = np.asarray(jmod.apply(v, xj).astype(jnp.float32))
    conv = nn.Conv2d(cin, 24, k, s, p, d, bias=False)
    conv.load_state_dict(weights.conv(v["params"]))
    xt = t(x).to(tdt)
    assert float(conv_int8.activation_scale(xt)) == 2.0 ** -4
    halves = (xt.float() * 16 - 0.5) == torch.round(xt.float() * 16 - 0.5)
    assert int(halves.sum()) > x.size // 16
    np.testing.assert_array_equal(conv_int8.qconv2d(xt, conv, tdt).float().numpy(), ref)
    q, wk = conv_int8.quantize_weight(conv.weight)
    plain = conv_int8.conv2d_w8a8_plain(xt, conv_int8.pack_weight(q),
                                        conv_int8.activation_scale(xt), wk, (k, k), (s, s),
                                        (p, p), (d, d), tdt)
    np.testing.assert_array_equal(plain.float().numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_scale_is_jax_max(dtype):
    """The one-pass scale (``torch.linalg.vector_norm``, inf) bit for bit
    JAX's ``max(max(|x|) in x's dtype, 1e-8) / 127``, and the maximum in x's
    dtype equal to ``jnp.max(jnp.abs(x))``; an all-zero input takes the
    floor."""
    rng = np.random.RandomState(14)
    for x in (rng.randn(3, 17, 19, 24).astype(np.float32) * 5,
              np.zeros((1, 3, 4, 8), np.float32)):
        xj = jnp.asarray(x).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)
        xt = t(x).to(torch.bfloat16) if dtype == "bfloat16" else t(x)
        amax = torch.linalg.vector_norm(xt, float("inf"))
        assert amax.dtype == xt.dtype
        assert float(amax) == float(jnp.max(jnp.abs(xj)))
        ref = jnp.maximum(jnp.max(jnp.abs(xj)).astype(jnp.float32), 1e-8) / 127.0
        got = conv_int8.activation_scale(xt)
        assert got.shape == (1,) and got.dtype == torch.float32
        assert got.numpy().view(np.int32)[0] == np.asarray(ref, np.float32).view(np.int32)


@pytest.mark.parametrize("cin,k,s,p,d", [(3, 7, 2, 3, 1), (20, 3, 2, 2, 2), (16, 3, 1, 4, 4)])
def test_im2col_plain_rows_give_the_convolution(cin, k, s, p, d):
    """``im2col_plain``'s rows (the plain version of the stem's first pass)
    times the packed weights are the integer convolution of the levels:
    the rows hold each output pixel's taps in the packed weights' (ky, kx,
    c) order, zeros outside the map and up to Kp."""
    g = torch.Generator().manual_seed(15)
    q = torch.randint(-127, 128, (2, 13, 15, cin), generator=g, dtype=torch.int8)
    qw = torch.randint(-127, 128, (24, cin, k, k), generator=g, dtype=torch.int8)
    wt = conv_int8.pack_weight(qw)
    rows = conv_int8.im2col_plain(q, (k, k), (s, s), (p, p), (d, d), wt.shape[1])
    assert rows.dtype == torch.int8 and rows.shape[1] == wt.shape[1]
    assert not rows[:, k * k * cin:].any()
    want = F.conv2d(q.permute(0, 3, 1, 2).double(), qw.double(), None, s, p, d)
    got = (rows.double() @ wt.double().t()).view(2, want.shape[2], want.shape[3], 24)
    assert torch.equal(got.permute(0, 3, 1, 2), want)


def test_qconv8_weights_follow_the_module():
    """The quantized weights are made again after an in-place update or a
    ``load_state_dict``, never taken stale from the cache."""
    rng = np.random.RandomState(9)
    x = t(rng.randn(1, 7, 8, 16).astype(np.float32))
    conv = nn.Conv2d(16, 8, 3, padding=1, bias=False)
    first = conv_int8.qconv2d(x, conv, torch.float32)
    other = nn.Conv2d(16, 8, 3, padding=1, bias=False)
    conv.load_state_dict(other.state_dict())
    assert torch.equal(conv_int8.qconv2d(x, conv, torch.float32),
                       conv_int8.qconv2d(x, other, torch.float32))
    with torch.no_grad():
        conv.weight.mul_(2.0)
    again = conv_int8.qconv2d(x, conv, torch.float32)
    assert not torch.equal(again, first)
    assert torch.equal(again, conv_int8.qconv2d(x, conv, torch.float32))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_w8a8_backbone_matches_jax():
    """Each tap of the TINY w8a8 backbone against JAX's. Every convolution
    is bit for bit JAX's on the same input (``test_qconv8_is_bit_for_bit``),
    but the BatchNorms round differently in the last bit (half the elements
    of a tap), and an int8 network with per-tensor dynamic scales carries
    such a difference on: a value near a rounding midpoint lands one level
    apart, and where it is a tensor's largest the whole tensor's scale
    moves. So the port is held to JAX's w8a8 output no further from it than
    JAX's own w8a8 output is from its unquantized one (measured: 1e-5 of it
    before the first such flip, at most 1.06 of it after), and within 1e-5
    of the first tap's largest value, where no flip has happened."""
    rng = np.random.RandomState(10)
    images = rng.rand(1, 48, 64, 3).astype(np.float32)
    jmod = JaxBackbone(stage_sizes=(3, 4, 6, 3), quant="w8a8")
    v = perturb_variables(jax.jit(lambda x: jmod.init(KEY, x, False))(images), seed=11)
    ref = jax.jit(lambda v, x: jmod.apply(v, x, False))(v, images)
    ref_f32 = jax.jit(lambda v, x: JaxBackbone(stage_sizes=(3, 4, 6, 3)).apply(v, x, False))(
        v, images)
    port = load(ResNetDeepLabBackbone((3, 4, 6, 3), quant="w8a8"),
                weights.resnet_backbone(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = port(t(images))
    for i, (g, r, rf) in enumerate(zip(got, ref, ref_f32)):
        port_err, quant_err = _rel_l2(g.numpy(), r), _rel_l2(r, rf)
        print(f"w8a8 backbone tap {i}: |port - jax| {port_err:.3g}, |jax w8a8 - jax f32| "
              f"{quant_err:.3g} (relative L2)")
        assert port_err <= 2.0 * quant_err
    assert_close(got[0], ref[0], atol=1e-5 * float(np.abs(np.asarray(ref[0])).max()))


@pytest.mark.parametrize("byte", range(4))
def test_int8_to_f32_by_byte_permute(byte):
    """P3-q8's combine converts int8 to f32 without an I2F
    (``csrc/quad_sample_reduce.cu::s8_biased``): the word XOR 0x80808080
    holds each value plus 128; ``__byte_perm(x, 0x4B000000, 0x7540 | byte)``
    makes that byte the low mantissa byte of 2^23, and subtracting 2^23 +
    128 leaves the value. Emulated with int32 bit operations, it equals
    ``int8 -> float32`` for all 256 values at each byte position, whatever
    the word's other bytes."""
    vals = torch.arange(-128, 128, dtype=torch.int32)
    rng = np.random.RandomState(byte)
    b = torch.from_numpy(rng.randint(-128, 128, (256, 4)).astype(np.int32))
    b[:, byte] = vals
    word = ((b.to(torch.int64) & 0xFF) << torch.tensor([0, 8, 16, 24])).sum(1)
    word = torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)
    biased = word ^ torch.tensor(0x80808080 - 2**32, dtype=torch.int32)
    mantissa = ((biased >> (8 * byte)) & 0xFF) | 0x4B000000
    got = mantissa.view(torch.float32) - torch.tensor(8388736.0)
    assert torch.equal(got, vals.to(torch.int8).to(torch.float32))
