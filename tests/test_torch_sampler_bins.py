"""The binned, tile-owned sampler backward (``csrc/quad_sample_bwd.cu``) on the
CPU: its bins (``quad_bins``) and a plain emulation of how the kernel sums.

The emulation walks the kernel's tiles, clusters and workers in its order:
each 8x8 output tile reads the runs of its 9x9 top-left pixels from the bins,
cuts that list into one chunk per block of its cluster and per worker, sums
each top-left pixel's run within a chunk in order, adds a run's later pieces
to its first in worker order, sums the four tap arrays, then the cluster's
blocks in block order, and rounds once. It is held to
``quad_sample_bwd_plain`` and to the JAX package's ``grid_sample_2d_quad_pallas``
gradient (K2 ``_scatter_outer`` and K2p ``_scatter_outer_planes``, interpret
mode). The CUDA kernel itself is held to the plain version by
test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgsfusion_tpu.ops import pallas_sample
from hgsfusion_tpu.ops.pallas_sample import grid_sample_2d_quad_pallas
from hgsfusion_tpu_torch.ops.grid_sample import quad_sample_bwd_plain
from hgsfusion_tpu_torch.ops.quad_sample import quad_bins, quad_indices
from torch_parity import assert_close, one_torch_thread, t  # noqa: F401

# csrc/quad_sample_bwd.cu: TILE, CLUSTER, and one worker per warp of THREADS
TILE, CLUSTER, WORKERS = 8, 4, 256 // 32
BF16_ULP = 2.0 ** -7  # one bf16 rounding, relative


def tile_owned_bwd(grad_out, idx, w4, padded_shape, bins, cluster=CLUSTER, workers=WORKERS):
    """The map's gradient (B, H, W, C) summed as quad_sample_bwd.cu sums it,
    in f32 (f64 for f64 input), rounded once to grad_out's dtype."""
    b, hp2, wp2, c = padded_shape
    h, w = hp2 - 2, wp2 - 2
    order, start = (x.long() for x in bins)
    acc = torch.promote_types(grad_out.dtype, torch.float32)
    g, wts = grad_out.reshape(-1, c).to(acc), w4.to(acc)
    out = torch.zeros((b, h, w, c), dtype=acc)
    tl = TILE + 1
    for bi in range(b):
        for y0 in range(0, h, TILE):
            for x0 in range(0, w, TILE):
                # the tile's list and the tile-local top-left pixel of each entry
                queries, runs = [], []
                for r in range(tl):
                    for col in range(tl):
                        if y0 + r > h or x0 + col > w:
                            continue
                        p = (bi * hp2 + y0 + r) * wp2 + x0 + col
                        queries += order[start[p]:start[p + 1]].tolist()
                        runs += [r * tl + col] * int(start[p + 1] - start[p])
                m = len(queries)
                tile_sum = torch.zeros((TILE, TILE, c), dtype=acc)
                for rank in range(cluster):
                    k_lo, k_hi = m * rank // cluster, m * (rank + 1) // cluster
                    cuts = [k_lo + (k_hi - k_lo) * i // workers for i in range(workers + 1)]
                    pieces = {}  # run -> its pieces' sums in worker order
                    for k0, k1 in zip(cuts[:-1], cuts[1:]):
                        k = k0
                        while k < k1:
                            run, s = runs[k], torch.zeros((4, c), dtype=acc)
                            while k < k1 and runs[k] == run:
                                s = s + wts[queries[k], :, None] * g[queries[k]]
                                k += 1
                            pieces.setdefault(run, []).append(s)
                    taps = torch.zeros((4, TILE, TILE, c), dtype=acc)
                    for run, sums in pieces.items():
                        total = sums[0]
                        for s in sums[1:]:
                            total = total + s
                        lr, lc = divmod(run, tl)
                        for tap in range(4):
                            oy, ox = lr + tap // 2 - 1, lc + tap % 2 - 1
                            if 0 <= oy < TILE and 0 <= ox < TILE:
                                taps[tap, oy, ox] = total[tap]
                    tile_sum = tile_sum + (((taps[0] + taps[1]) + taps[2]) + taps[3])
                ys, xs = min(TILE, h - y0), min(TILE, w - x0)
                out[bi, y0:y0 + ys, x0:x0 + xs] = tile_sum[:ys, :xs]
    return out.to(grad_out.dtype)


def _case(name, dtype):
    """(features, coords, cotangent) on dyadic pixel coordinates (steps of
    1/8 on maps with H - 1 and W - 1 powers of 2, so the normalization is
    exact): a ragged map of odd width with out-of-bounds coords, a contention
    case (every query on one 2x2 patch), a hot case (most queries on three
    pixels, the rest spread over the map and beyond it), a wide map of at
    least 2^16 padded pixels, whose bins take 32-bit sort keys, and a map of
    65,535 padded pixels (255 x 257), the last that takes 16-bit keys: its
    sentinel key is the largest int16 (not dyadic: only its bins are
    checked)."""
    rng = np.random.RandomState({"ragged": 0, "contention": 1, "hot": 2, "wide": 3,
                                 "last16": 4}[name])
    shape = {"ragged": (2, 9, 17, 5), "contention": (1, 9, 9, 3), "hot": (2, 9, 17, 4),
             "wide": (1, 257, 257, 2), "last16": (1, 253, 255, 2)}[name]
    b, h, w, c = shape
    n = {"ragged": (12, 11), "contention": (40, 40), "hot": (24, 25), "wide": (30, 40),
         "last16": (30, 40)}[name]
    if name == "contention":
        px = np.full((b, *n, 2), 2.5)
    else:
        px = np.stack([rng.randint(-16, 8 * w + 9, (b, *n)),
                       rng.randint(-16, 8 * h + 9, (b, *n))], -1) / 8.0
        if name == "hot":
            hot = np.array([[3.25, 4.5], [11.0, 2.125], [16.0, 8.0]])
            pick = rng.rand(b, *n) < 0.8
            px[pick] = hot[rng.randint(0, 3, int(pick.sum()))]
    coords = px / np.array([w - 1, h - 1]) * 2.0 - 1.0
    # cotangents on the bf16 grid, so products and their sums stay exact in f64
    cot = t(rng.randn(b, *n, c).astype(np.float32), torch.bfloat16).to(dtype)
    return torch.zeros(shape, dtype=dtype), torch.from_numpy(coords).to(dtype), cot


def _bins_inputs(name, dtype):
    feats, coords, cot = _case(name, dtype)
    b, h, w, c = feats.shape
    idx, w4 = quad_indices(feats, coords)
    padded = (b, h + 2, w + 2, c)
    return cot.reshape(-1, c), idx, w4, padded, quad_bins(idx, w4, padded)


@pytest.mark.parametrize("name", ["ragged", "contention", "hot", "wide", "last16"])
def test_quad_bins_sort_the_nonzero_queries_by_pixel(name):
    _, idx, w4, padded, (order, start) = _bins_inputs(name, torch.float64)
    n, pixels = idx.numel(), int(np.prod(padded[:3]))
    assert order.dtype == start.dtype == torch.int32
    assert order.shape == (n,) and start.shape == (pixels + 1,)
    valid = (w4 != 0).any(dim=1)
    nv = int(start[-1])
    assert 0 < nv == int(valid.sum())
    assert nv < n or name == "contention"  # out-of-bounds queries carry no weight
    o = order.long()
    # every query once: the nonzero ones first, then the rest in query order
    assert torch.equal(torch.sort(o).values, torch.arange(n))
    assert bool(valid[o[:nv]].all()) and torch.equal(o[nv:], torch.nonzero(~valid)[:, 0])
    # sorted by pixel, stable in query order
    key = idx.long()[o[:nv]]
    assert bool(((key[1:] > key[:-1]) | ((key[1:] == key[:-1]) & (o[1:nv] > o[:nv - 1]))).all())
    # start partitions them: pixel p's run is order[start[p]:start[p + 1]]
    assert int(start[0]) == 0 and bool((start[1:] >= start[:-1]).all())
    runs = torch.repeat_interleave(torch.arange(pixels), (start[1:] - start[:-1]).long())
    assert torch.equal(runs, key)


@pytest.mark.parametrize("cluster,workers", [(CLUSTER, WORKERS), (2, 3), (1, 1)])
@pytest.mark.parametrize("name", ["ragged", "contention", "hot"])
def test_tile_owned_sum_equals_plain_f64(name, cluster, workers):
    """f64 on dyadic weights and bf16-grid cotangents: every sum is exact, so
    the kernel's order gives the plain version's result bit for bit: each
    contribution is added once, to the right pixel."""
    g, idx, w4, padded, bins = _bins_inputs(name, torch.float64)
    ref = quad_sample_bwd_plain(g, idx, w4, padded)
    got = tile_owned_bwd(g, idx, w4, padded, bins, cluster, workers)
    assert got.dtype == torch.float64 and got.shape == ref.shape
    assert bool(ref.abs().max() > 0)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("name", ["ragged", "contention", "hot"])
def test_tile_owned_sum_within_one_rounding_bf16(name):
    """bf16: both sum in f32 (in another order) and round once, so they are
    at most one bf16 rounding apart."""
    g, idx, w4, padded, bins = _bins_inputs(name, torch.bfloat16)
    ref = quad_sample_bwd_plain(g, idx, w4, padded)
    got = tile_owned_bwd(g, idx, w4, padded, bins)
    assert got.dtype == torch.bfloat16
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= BF16_ULP * ref.float().abs()).all())


@pytest.fixture(params=["rows", "planes"])
def pallas_layout(monkeypatch, request):
    monkeypatch.setattr(pallas_sample, "TILE", 64)
    monkeypatch.setattr(pallas_sample, "LAYOUT", request.param)


@pytest.mark.parametrize("shape", [(1, 9, 13, 64), (2, 7, 5, 192)])
def test_bins_and_tile_owned_sum_match_jax_f32(shape, pallas_layout):
    """f32: quad_bins plus the kernel's summation order against jax.grad
    through grid_sample_2d_quad_pallas, within the bound the JAX package
    holds its pallas gradient to (1e-5)."""
    rng = np.random.RandomState(5)
    feats = rng.randn(*shape).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (shape[0], 10, 13, 2)).astype(np.float32)
    cot = rng.randn(shape[0], 10, 13, shape[-1]).astype(np.float32)
    b, h, w, c = shape
    idx, w4 = quad_indices(t(feats), t(coords))
    padded = (b, h + 2, w + 2, c)
    got = tile_owned_bwd(t(cot).reshape(-1, c), idx, w4, padded, quad_bins(idx, w4, padded))
    cj, ctj = jnp.asarray(coords), jnp.asarray(cot)
    ref = jax.grad(lambda f: jnp.sum(grid_sample_2d_quad_pallas(f, cj) * ctj))(jnp.asarray(feats))
    assert got.shape == shape and got.dtype == torch.float32
    assert_close(got, ref, atol=1e-5, rtol=1e-5)
