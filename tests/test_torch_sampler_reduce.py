"""The fused sampler + reduce (``quad_sample_reduce_plain``, the plain version
of the ``quad_sample_reduce_fwd`` kernel) and the gather view's no-grad route
through it, on the CPU.

(a) The plain version against the TPU prototype it ports,
``_bench_gather_pallas.py::pallas_gather_combine_matmul``, run in Pallas
interpret mode with a small tile (the script is used as it is: its module
globals and ``pl.pallas_call`` are patched from here). (b) The module's fused
route (no gradient taken) against its sampling route (gradients taken), which
of the two each grad mode takes, and that the fused route hands the grid's
(u, v) and the unpadded maps to the kernel's contract without building a
padded map or tap indices. (c) The fused route against the JAX module in f32
and bf16 under both ``SAMPLER_KERNEL``s, the JAX Pallas sampler in interpret
mode. The kernel itself is tested on the card by test_torch_cuda.py.
"""
import functools

import _bench_gather_pallas as p3
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hgsfusion_tpu.models.frustum import FrustumToVoxelMultiScale as JaxF2V
from hgsfusion_tpu.ops import pallas_sample
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.models import frustum
from hgsfusion_tpu_torch.models.frustum import FrustumToVoxelMultiScale
from hgsfusion_tpu_torch.ops import quad_sample
from hgsfusion_tpu_torch.ops.grid_sample import quad_sample_fwd_plain
from hgsfusion_tpu_torch.ops.quad_sample import quad_indices, quad_sample_reduce_plain
from torch_parity import load, one_torch_thread, perturb_variables, t  # noqa: F401

P3_QUERIES, P3_TILE = 64, 32
U_BF16 = 2.0 ** -8  # bf16 unit round-off


@pytest.fixture
def p3_interpret(monkeypatch):
    """P3 at 64 queries in tiles of 32, every ``pallas_call`` interpreted."""
    monkeypatch.setattr(p3, "N_PAD", P3_QUERIES)
    monkeypatch.setattr(p3, "TILE", P3_TILE)
    monkeypatch.setattr(p3.pl, "pallas_call",
                        functools.partial(p3.pl.pallas_call, interpret=True))


def _group(rng, shape, dtype, n):
    """One gather group: the features, the coords (some beyond the map)."""
    feats = t(rng.randn(*shape).astype(np.float32), dtype)
    coords = t(rng.uniform(-1.2, 1.2, (shape[0], n, 2)).astype(np.float32))
    return feats, coords


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_p3(p3_interpret, dtype):
    """One group (B = 1, c = 16, O = 24) through P3's quad table (4 taps per
    row at the row index yp (W + 1) + xp) and through the plain version.
    Both write the table's dtype (P3's ``out_shape``). f32: within 1e-5.
    bf16: each rounds its f32 sum once to bf16 (2^-8 |ref| each, so 2^-7
    |ref|), and both combine the taps in bf16 in the same order, where the
    compiler may keep excess precision in one and not the other: at most 8
    roundings of 2^-8 on the sum of |tap x weight| (S), so 2^-5 (S @ |K|) on
    the output."""
    rng = np.random.RandomState(0)
    h, w, c, o = 9, 13, 16, 24
    feats, coords = _group(rng, (1, h, w, c), dtype, P3_QUERIES)
    idx, w4 = quad_indices(feats, coords)
    fp = F.pad(feats, (0, 0, 1, 1, 1, 1))
    kmat = t(rng.randn(c, o).astype(np.float32) * 0.25, dtype)
    got = quad_sample_reduce_plain(coords, [(feats, 0)], kmat, torch.zeros(o))

    quad = torch.cat([fp[:, :-1, :-1], fp[:, :-1, 1:], fp[:, 1:, :-1], fp[:, 1:, 1:]], dim=-1)
    yp, xp = idx.long() // (w + 2), idx.long() % (w + 2)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    table = jnp.asarray(quad.reshape(-1, 4 * c).float().numpy()).astype(jdt)
    ref = p3.pallas_gather_combine_matmul(
        jnp.asarray((yp * (w + 1) + xp).to(torch.int32).numpy()), table,
        jnp.asarray(w4.numpy()), jnp.asarray(kmat.float().numpy()).astype(jdt), 4 * c)
    assert ref.dtype == jdt
    ref = np.asarray(ref.astype(jnp.float32), np.float64)
    assert ref.shape == (P3_QUERIES, o) and got.dtype == dtype
    err = np.abs(got.double().numpy() - ref)
    if dtype == torch.float32:
        assert err.max() <= 1e-5, err.max()
    else:
        s_abs = quad_sample_fwd_plain(fp.double().abs(), idx, w4.double().abs())
        tol = 2 * U_BF16 * np.abs(ref) + 8 * U_BF16 * (s_abs @ kmat.double().abs()).numpy()
        ratio = (err / np.maximum(tol, 1e-30)).max()
        print(f"bf16: max |plain - P3| {err.max():.3g}, at most {ratio:.3g} of the tolerance")
        assert (err <= tol).all()


def _f2v_inputs(seed, dtype):
    """Four maps (one at /4, three at /8: two gather groups) and a grid."""
    rng = np.random.RandomState(seed)
    feats = [t(rng.randn(1, 9, 13, 16).astype(np.float32), dtype)] + [
        t(rng.randn(1, 5, 7, 16).astype(np.float32), dtype) for _ in range(3)]
    grid = t(rng.uniform(-1.2, 1.2, (1, 6, 7, 5, 3)).astype(np.float32))
    return feats, grid


def _f2v(dtype, seed=4):
    f2v = FrustumToVoxelMultiScale([16] * 4, 24, dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        f2v.channel_reduce[0].weight.copy_(torch.randn(f2v.channel_reduce[0].weight.shape,
                                                       generator=g) * 0.25)
        f2v.channel_reduce[0].bias.copy_(torch.randn(24, generator=g))
    return f2v.eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_route_matches_sampling_route(dtype):
    """Under inference_mode (fused) and with gradients taken (per-group
    samples, matmul_f32): the accumulator (the fused route's in the compute
    dtype, the sampling route's in f32, cast as the module casts it) and the
    module's output within 1e-6 of their largest value."""
    feats, grid = _f2v_inputs(5, dtype)
    f2v = _f2v(dtype)
    with torch.inference_mode():
        fused_acc = f2v.accumulate(feats, grid)
        fused = f2v(feats, grid)
    ref_acc = f2v.accumulate(feats, grid)
    ref = f2v(feats, grid)
    assert ref_acc.requires_grad and not fused_acc.requires_grad
    assert fused_acc.dtype == dtype and ref_acc.dtype == torch.float32
    for got, want in ((fused_acc, ref_acc.to(dtype)), (fused, ref)):
        assert got.shape == want.shape and got.dtype == want.dtype
        scale = float(want.detach().abs().max())
        assert float((got.float() - want.detach().float()).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad", "frozen", "grad"])
def test_grad_mode_picks_the_route(monkeypatch, mode):
    """One fused call for the two groups where no gradient is taken; one
    sample per group where one is."""
    calls = {"fused": 0, "sampled": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    # the CPU implementation of the op hgsfusion::quad_sample_reduce_fwd
    monkeypatch.setattr(quad_sample, "quad_sample_reduce_plain",
                        spy("fused", quad_sample.quad_sample_reduce_plain))
    monkeypatch.setattr(frustum, "grid_sample_2d_quad_kernel",
                        spy("sampled", frustum.grid_sample_2d_quad_kernel))
    feats, grid = _f2v_inputs(6, torch.float32)
    f2v = _f2v(torch.float32)
    if mode == "frozen":
        f2v.requires_grad_(False)
    ctx = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad}.get(
        mode, torch.enable_grad)
    with ctx():
        out = f2v(feats, grid)
    want = {"fused": 0, "sampled": 2} if mode == "grad" else {"fused": 1, "sampled": 0}
    assert calls == want
    assert out.requires_grad == (mode == "grad")


def test_fused_route_takes_uv_and_unpadded_maps(monkeypatch):
    """The no-grad route hands the kernel's contract to the plain version
    (the CPU route): the grid's (u, v) as a view of the grid, the unpadded
    maps (the three /8 maps joined into one group) and no tap indices; the
    module itself pads no map and computes no taps (``F.pad`` and
    ``quad_indices`` run only inside the plain version)."""
    seen, outside = [], {"pad": 0, "quad_indices": 0}
    inside = [False]

    def plain(uv, groups, kmat, bias):
        seen.append((uv, groups, kmat, bias))
        inside[0] = True
        try:
            return quad_sample_reduce_plain(uv, groups, kmat, bias)
        finally:
            inside[0] = False

    def count(name, fn):
        def wrapped(*a, **k):
            if not inside[0]:
                outside[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(quad_sample, "quad_sample_reduce_plain", plain)  # the op's CPU route
    monkeypatch.setattr(F, "pad", count("pad", F.pad))
    monkeypatch.setattr(quad_sample, "quad_indices",
                        count("quad_indices", quad_sample.quad_indices))
    feats, grid = _f2v_inputs(9, torch.bfloat16)
    f2v = _f2v(torch.bfloat16)
    with torch.inference_mode():
        out = f2v(feats, grid)
    assert outside == {"pad": 0, "quad_indices": 0} and len(seen) == 1
    uv, groups, kmat, bias = seen[0]
    assert uv.data_ptr() == grid.data_ptr() and uv.shape == grid.shape[:-1] + (2,)
    assert uv.stride() == grid.stride()
    assert [(tuple(f.shape), f.dtype, k) for f, k in groups] == [
        ((1, 9, 13, 16), torch.bfloat16, 0), ((1, 5, 7, 48), torch.bfloat16, 16)]
    assert all(f.is_contiguous() for f, _ in groups)
    assert kmat.dtype == torch.bfloat16 and bias.dtype == torch.float32
    assert out.dtype == torch.bfloat16 and out.shape == grid.shape[:-1] + (24,)


# bf16 against the JAX module: both round the f32 accumulator once to bf16
# and run BN and ReLU in bf16; the port's plain version combines the taps as
# the JAX samplers do, so the outputs may differ by one bf16 rounding of an
# output (2^-7 of the largest: one unit in the last place)
F2V_JAX_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sampler_kernel", ["xla", "pallas"])
def test_fused_route_matches_jax(monkeypatch, sampler_kernel, dtype):
    """The gather view transform in eval mode, a random reduce bias: the
    port's fused route against the JAX module, f32 within 1e-5 and bf16
    within F2V_JAX_TOL of the largest output."""
    monkeypatch.setattr(pallas_sample, "TILE", 64)
    feats, grid = _f2v_inputs(7, torch.float32)
    fj = [f.numpy() for f in feats]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else None
    jf2v = JaxF2V(out_channels=24, sampler_kernel=sampler_kernel, dtype=jdt)
    v = perturb_variables(jax.jit(lambda: jf2v.init(jax.random.PRNGKey(0), fj, grid.numpy(),
                                                    False))(), seed=3)
    v["params"]["reduce_bias"] = np.random.RandomState(8).randn(24).astype(np.float32)
    cast = [jnp.asarray(f).astype(jdt) if jdt else f for f in fj]
    ref = np.asarray(jf2v.apply(v, cast, grid.numpy(), False, mutable=["batch_stats"])[0],
                     np.float32)
    tdt = dtype if dtype == torch.bfloat16 else None
    f2v = load(FrustumToVoxelMultiScale([16] * 4, 24, dtype=tdt, sampler_kernel=sampler_kernel),
               weights.frustum_to_voxel(v["params"], v["batch_stats"]))
    with torch.inference_mode():
        got = f2v([f.to(dtype) for f in feats], grid)
    assert got.dtype == dtype
    got = got.float().numpy()
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    print(f"f2v {sampler_kernel} {dtype}: max |port - jax| {err:.3g} of max {scale:.3g} "
          f"({err / scale:.3g})")
    assert got.shape == ref.shape
    assert err <= F2V_JAX_TOL[dtype] * scale
