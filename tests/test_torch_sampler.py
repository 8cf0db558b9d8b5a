"""The port's quad sampler against the JAX package's samplers.

The JAX Pallas kernels run in interpret mode on the CPU with a 64-row tile,
under both table layouts; the port's wrapper takes its plain version for
CPU tensors (``quad_sample_fwd_uv_plain``: the sampling coordinates read
as given, the unpadded map). The kernel itself is tested on the card by
test_torch_cuda.py.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hgsfusion_tpu.ops import pallas_sample
from hgsfusion_tpu.ops.grid_sample import grid_sample_2d_quad as jax_quad
from hgsfusion_tpu.ops.pallas_sample import grid_sample_2d_quad_pallas
from chip_smoke import TINY_POLAR, TINY_XLA, edge_coords, outside_coords, tiny_batch
from hgsfusion_tpu_torch import native
from hgsfusion_tpu_torch.config import HGSFusionConfig
from hgsfusion_tpu_torch.models.detector import HGSFusionModel
from hgsfusion_tpu_torch.ops.grid_sample import grid_sample_2d_quad
from hgsfusion_tpu_torch.ops import quad_sample
from hgsfusion_tpu_torch.ops.quad_sample import grid_sample_2d_quad_kernel, quad_indices
from torch_parity import assert_close, one_torch_thread, t  # noqa: F401

SHAPES = [(1, 9, 13, 64), (2, 7, 5, 192)]
# the JAX package's own bounds between its pallas and xla samplers
F32_TOL = 1e-6
BF16_TOL = 0.04


@pytest.fixture(params=["rows", "planes"])
def pallas_layout(monkeypatch, request):
    monkeypatch.setattr(pallas_sample, "TILE", 64)
    monkeypatch.setattr(pallas_sample, "LAYOUT", request.param)


def _inputs(seed, shape, queries=(10, 13)):
    """Features and normalized coords incl. out-of-bounds (-1.3 .. 1.3)."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(*shape).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (shape[0],) + queries + (2,)).astype(np.float32)
    return feats, coords


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_f32(shape, pallas_layout):
    feats, coords = _inputs(0, shape)
    got = grid_sample_2d_quad_kernel(t(feats), t(coords))
    assert got.shape == coords.shape[:-1] + (shape[-1],)
    fj, cj = jnp.asarray(feats), jnp.asarray(coords)
    assert_close(got, grid_sample_2d_quad_pallas(fj, cj), atol=F32_TOL)
    assert_close(got, jax_quad(fj, cj), atol=F32_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_bf16(shape, pallas_layout):
    feats, coords = _inputs(1, shape)
    got = grid_sample_2d_quad(t(feats, torch.bfloat16), t(coords))
    assert got.dtype == torch.bfloat16
    fj, cj = jnp.asarray(feats).astype(jnp.bfloat16), jnp.asarray(coords)
    assert_close(got, grid_sample_2d_quad_pallas(fj, cj).astype(jnp.float32), atol=BF16_TOL)
    assert_close(got, jax_quad(fj, cj).astype(jnp.float32), atol=BF16_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_glue_indexes_the_padded_map(shape):
    """The kernel's addressing, replayed on the CPU. The idx it writes for
    the backward indexes the padded map: the four taps at idx, idx+1,
    idx+W+2, idx+W+3, summed in f32, equal the plain version. It reads the
    unpadded map: the top-left tap at pixel (yp - 1, xp - 1), the others
    one column and one row on, each only where its weight is not 0 (a tap
    outside the map always has weight 0); the same sum."""
    feats, coords = _inputs(2, shape)
    f, c = t(feats), t(coords)
    idx, w4 = quad_indices(f, c)
    assert idx.dtype == torch.int32 and w4.dtype == torch.float32
    fp = F.pad(f, (0, 0, 1, 1, 1, 1)).reshape(-1, shape[-1])
    i, row = idx.long(), shape[2] + 2
    out = (w4[:, 0:1] * fp[i] + w4[:, 1:2] * fp[i + 1]
           + w4[:, 2:3] * fp[i + row] + w4[:, 3:4] * fp[i + row + 1])
    want = grid_sample_2d_quad(f, c).numpy()
    assert_close(out.reshape(coords.shape[:-1] + (shape[-1],)), want, atol=F32_TOL)

    b, h, w, ch = shape
    frame, rest = i // ((h + 2) * row), i % ((h + 2) * row)
    yp, xp = rest // row, rest % row
    flat = f.reshape(-1, ch)
    out = torch.zeros_like(out)
    for tap, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        y, x = yp - 1 + dy, xp - 1 + dx
        read = w4[:, tap] != 0
        inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        assert bool(inside[read].all())
        pix = ((frame * h + y) * w + x)[read]
        out[read] += w4[read, tap:tap + 1] * flat[pix]
    assert_close(out.reshape(coords.shape[:-1] + (ch,)), want, atol=F32_TOL)


# (B, Y, X, Z) of a view-transform grid whose (u, v) the route reads in place
GRID = (3, 4, 5)


def _grid_inputs(seed, shape):
    """Features and a (B, Y, X, Z, 3) grid, (u, v) in -1.3 .. 1.3."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(*shape).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (shape[0],) + GRID + (3,)).astype(np.float32)
    return feats, grid


def _against_jax(feats, coords, dtype):
    """The port's CPU route on ``coords`` (a torch tensor, any strides)
    against the Pallas sampler and the XLA one at the file's bounds."""
    tdt, tol = {"float32": (torch.float32, F32_TOL), "bfloat16": (torch.bfloat16, BF16_TOL)}[dtype]
    got = grid_sample_2d_quad_kernel(t(feats, tdt), coords)
    assert got.dtype == tdt and got.shape == coords.shape[:-1] + (feats.shape[-1],)
    fj, cj = jnp.asarray(feats).astype(dtype), jnp.asarray(coords.contiguous().numpy())
    assert_close(got, grid_sample_2d_quad_pallas(fj, cj).astype(jnp.float32), atol=tol)
    assert_close(got, jax_quad(fj, cj).astype(jnp.float32), atol=tol)
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 9, 13, 64), (2, 7, 5, 192)])
def test_route_reads_strided_uv(shape, dtype, pallas_layout):
    """``grid[..., 0:2]`` of a (B, Y, X, Z, 3) grid, B = 2, as the view
    transform passes it: rows of stride 3, read as they are."""
    feats, grid = _grid_inputs(3, shape)
    uv = t(grid)[..., 0:2]
    assert not uv.is_contiguous() and uv.stride(-2) == 3
    _against_jax(feats, uv, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_at_edges_and_outside(dtype, pallas_layout):
    """Coordinates on, beside and beyond every edge of a 5 x 7 map, and
    coordinates wholly outside an 11 x 17 map (an all-zero output)."""
    rng = np.random.RandomState(4)
    feats = rng.randn(1, 5, 7, 8).astype(np.float32)
    _against_jax(feats, edge_coords("cpu", (5, 7), n=256), dtype)
    feats = rng.randn(2, 11, 17, 16).astype(np.float32)
    got = _against_jax(feats, outside_coords("cpu", n=200), dtype)
    assert not bool(got.any())


@pytest.mark.parametrize("shape", [(2, 9, 13, 64), (2, 7, 5, 192)])
def test_route_gradient_matches_jax_vjp(shape, pallas_layout):
    """The map's gradient through the route on a strided uv against the VJP
    of the Pallas and the XLA sampler, f32 (test_torch_sampler_bwd.py's
    bound, 1e-5)."""
    feats, grid = _grid_inputs(5, shape)
    cot = np.random.RandomState(6).randn(shape[0], *GRID, shape[-1]).astype(np.float32)
    f = t(feats).requires_grad_()
    out = grid_sample_2d_quad_kernel(f, t(grid)[..., 0:2])
    (out * t(cot)).sum().backward()
    cj = jnp.asarray(grid[..., 0:2])
    for fn in (grid_sample_2d_quad_pallas, jax_quad):
        _, vjp = jax.vjp(lambda m: fn(m, cj), jnp.asarray(feats))
        assert_close(f.grad, vjp(jnp.asarray(cot))[0], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cfg", [TINY_XLA, TINY_POLAR], ids=["gather", "polar"])
def test_model_feeds_the_sampler_in_place(cfg, monkeypatch):
    """In a training step's view transform every map reaches the sampler
    contiguous (so its ``.contiguous()`` copies nothing and the card's route
    is one launch) and the gather grids' (u, v) as strided views of their
    grids, read in place."""
    seen = []
    forward = quad_sample._QuadSample.forward

    def spy(ctx, features, coords):
        seen.append((features.is_contiguous(), coords.is_contiguous(), coords.stride(-2)))
        return forward(ctx, features, coords)

    monkeypatch.setattr(quad_sample._QuadSample, "forward", staticmethod(spy))
    model = HGSFusionModel(cfg, device="cpu", seed=5).train()
    batch = model.batch_to_device(tiny_batch())
    model.view_transform(model.image_features(batch), batch).float().sum().backward()
    # gather: two groups on the frustum grid; polar: two near-field maps on
    # the near grid, then pass 3's coordinates (their own tensor)
    want = {"gather": [(True, False, 3)] * 2,
            "polar": [(True, False, 3)] * 2 + [(True, True, 2)]}[cfg.f2v_view]
    assert seen == want


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """A kernel library's name changes with a header its source includes, so
    an edited header never loads a stale library."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(native, "CSRC_DIR", tmp_path)
    first = native.library_path("k")
    assert native.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert native.library_path("k") != first


def test_taps_are_computed_in_one_place():
    """``quad_tap`` is defined once, in the shared header, which both
    sampling kernels include."""
    sources = {p.name: p.read_text() for p in native.CSRC_DIR.iterdir()
               if p.suffix in (".cu", ".cuh")}
    defined = [name for name, text in sources.items()
               if re.search(r"QuadTap quad_tap\(", text)]
    assert defined == ["quad_taps.cuh"]
    for name in ("quad_sample.cu", "quad_sample_reduce.cu"):
        assert '#include "quad_taps.cuh"' in sources[name]


def test_entry_point_without_cuda_raises(monkeypatch):
    """Without a CUDA device an entry point asked for none raises; it runs on
    the CPU only when asked to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = HGSFusionConfig(pc_range=(0.0, -2.0, -1.0, 4.0, 2.0, 1.0), voxel_size=(0.5, 0.5, 0.5),
                          image_size=(32, 48), image_backbone="ResNet50",
                          f2v_sampler_kernel="pallas")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HGSFusionModel(cfg)
    assert HGSFusionModel(cfg, device="cpu").device.type == "cpu"
