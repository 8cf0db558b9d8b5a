"""The row scatter-add (``ops/row_scatter.py``: ``row_scatter_add_plain``,
the plain version of the ``row_scatter_add`` kernel, and the kernel's bins)
against the TPU prototype it ports, on the CPU.

``_bench_scatter_pallas.py::pallas_scatter`` (P5) runs in Pallas interpret
mode at 128 updates in tiles of 32 into a 40 x 16 bf16 table (the script is
used as it is: its module globals and ``pl.pallas_call`` are patched from
here), on its own ``make_inputs``. Integer-valued updates sum exactly in any
order and are compared bit for bit. Random bf16 updates: P5 adds each row
into the bf16 table, a rounding per add, and the plain version sums in f32
and rounds once, so they differ by at most the sequential bf16 bound k u S
(k the row's updates, S their sum of |x|, u = 2^-8) plus one rounding of
the result, 2 u |plain|, and the f32 order bound. Out-of-range indices are
held to the script's ``xla_scatter`` (``.at[idx].add``), which P5 does not
check. The kernel itself is tested on the card by test_torch_cuda.py.
"""
import functools

import _bench_scatter_pallas as p5
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgsfusion_tpu_torch import bench_scatter
from hgsfusion_tpu_torch.ops.row_scatter import (row_scatter_add, row_scatter_add_plain,
                                                 row_scatter_bins)
from torch_parity import one_torch_thread  # noqa: F401

P5_ROWS, P5_TILE, TABLE = 128, 32, (40, 16)
U_BF16, U_F32 = 2.0 ** -8, 2.0 ** -24


@pytest.fixture
def p5_interpret(monkeypatch):
    """P5 at 128 updates in tiles of 32, every ``pallas_call`` interpreted."""
    monkeypatch.setattr(p5, "N_PAD", P5_ROWS)
    monkeypatch.setattr(p5, "TILE", P5_TILE)
    monkeypatch.setattr(p5.pl, "pallas_call",
                        functools.partial(p5.pl.pallas_call, interpret=True))


def _torch(a, dtype=None):
    out = torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32)))
    return out if dtype is None else out.to(dtype)


def _p5(idx, upd):
    p, cq = TABLE
    out = p5.pallas_scatter(jnp.asarray(idx.numpy()), jnp.asarray(upd.float().numpy()).astype(
        jnp.bfloat16), p, cq)
    return _torch(out, torch.bfloat16)


def test_plain_matches_p5_on_integers(p5_interpret):
    """Small-integer updates at P5's own indices: bit for bit."""
    idx, _, _, _ = p5.make_inputs(*TABLE)
    idx = torch.from_numpy(np.array(idx))
    upd = torch.from_numpy(np.random.RandomState(0).randint(-4, 5, (P5_ROWS, TABLE[1]))).to(
        torch.bfloat16)
    got = row_scatter_add_plain(idx, upd, TABLE[0])
    assert got.dtype == torch.bfloat16 and got.shape == TABLE
    assert torch.equal(got, _p5(idx, upd))
    assert torch.equal(row_scatter_add(idx, upd, TABLE[0]), got)  # the CPU route
    assert bool(got.any())


def test_plain_matches_p5_on_random_rows(p5_interpret):
    """P5's own inputs (``make_inputs``): random bf16 rows."""
    idx, upd, _, _ = p5.make_inputs(*TABLE)
    idx, upd = torch.from_numpy(np.array(idx)), _torch(upd, torch.bfloat16)
    got = row_scatter_add_plain(idx, upd, TABLE[0]).double()
    ref = _p5(idx, upd).double()
    s_abs = row_scatter_add_plain(idx, upd.float().abs(), TABLE[0]).double()
    k = torch.bincount(idx.long(), minlength=TABLE[0]).double()[:, None]
    tol = k * U_BF16 * s_abs + 2 * U_BF16 * got.abs() + k * U_F32 * s_abs
    err = (got - ref).abs()
    assert bool((err <= tol).all()), float((err / tol.clamp(min=1e-30)).max())
    assert float(err.max()) > 0  # P5's roundings do show: the bound is used


def test_out_of_range_is_dropped_as_xla():
    """Indices past the table and below -num_rows are dropped; negative ones
    inside it count from the end, as ``.at[idx].add`` does."""
    rng = np.random.RandomState(2)
    p, cq = TABLE
    idx = rng.randint(-p - 15, p + 15, 300).astype(np.int32)
    upd = rng.randint(-3, 4, (300, cq)).astype(np.float32)
    ref = _torch(p5.xla_scatter(jnp.asarray(idx), jnp.asarray(upd).astype(jnp.bfloat16), p, cq),
                 torch.bfloat16)
    got = row_scatter_add(torch.from_numpy(idx), torch.from_numpy(upd).to(torch.bfloat16), p)
    assert torch.equal(got, ref)
    assert ((idx < -p) | (idx >= p)).sum() > 20 and ((idx < 0) & (idx >= -p)).sum() > 20
    assert torch.equal(row_scatter_add(torch.from_numpy(idx).long(),
                                       torch.from_numpy(upd).to(torch.bfloat16), p), got)


@pytest.mark.parametrize("num_rows", [300, 70_000])  # 16-bit and 32-bit sort keys
def test_bins_give_the_sum(num_rows):
    """The kernel's contract, walked on the CPU: each row's run of
    ``order`` holds its updates in update order, the dropped ones after
    ``start[-1]``, and summing the runs gives the plain version."""
    rng = np.random.RandomState(4)
    n = 2000
    idx = torch.from_numpy(rng.randint(-num_rows - 50, num_rows + 50, n).astype(np.int32))
    idx[:300] = 7  # a hot row
    rows = torch.from_numpy(rng.randint(-3, 4, (n, 5)).astype(np.float32))
    order, start = row_scatter_bins(idx, num_rows)
    assert order.dtype == start.dtype == torch.int32 and start.shape == (num_rows + 1,)
    dest = torch.where(idx < 0, idx + num_rows, idx).long()
    keep = (dest >= 0) & (dest < num_rows)
    assert int(start[-1]) == int(keep.sum()) and int(start[0]) == 0
    assert not bool(keep[order[int(start[-1]):].long()].any())
    out = torch.zeros((num_rows, 5))
    for r in torch.nonzero(start.diff()).reshape(-1).tolist():
        run = order[int(start[r]):int(start[r + 1])].long()
        assert bool((dest[run] == r).all()) and bool((run.diff() > 0).all())
        out[r] = rows[run].sum(0)
    assert torch.equal(out, row_scatter_add_plain(idx, rows, num_rows))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    rows = torch.zeros((3, 8))
    with pytest.raises(ValueError, match="shapes"):
        row_scatter_add(torch.zeros(2, dtype=torch.int32), rows, 4)
    with pytest.raises(TypeError, match="int32 or int64"):
        row_scatter_add(torch.zeros(3), rows, 4)
    empty = row_scatter_add(torch.zeros(0, dtype=torch.int32), torch.zeros((0, 8)), 4)
    assert torch.equal(empty, torch.zeros((4, 8)))


def test_bench_inputs_are_the_tpu_scripts(monkeypatch):
    """``bench_scatter.make_inputs`` draws what the TPU script's does (here
    at 4 tiles of 32), and the bench refuses to run without a card."""
    for mod in (p5, bench_scatter):
        monkeypatch.setattr(mod, "N_PAD", P5_ROWS)
        monkeypatch.setattr(mod, "TILE", P5_TILE)
    for p, cq in ((40, 16), (3000, 8)):
        got = bench_scatter.make_inputs(p, cq, "cpu")
        want = p5.make_inputs(p, cq)
        assert torch.equal(got[0], torch.from_numpy(np.array(want[0])))
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == torch.bfloat16 and torch.equal(g, _torch(w, torch.bfloat16))
    assert [c[0] for c in bench_scatter.CASES] == [c[0] for c in p5.CASES]
    assert [c[1:] for c in bench_scatter.CASES] == [c[1:] for c in p5.CASES]
    assert bench_scatter.N == p5.N
    with pytest.raises(SystemExit, match="CUDA"):
        bench_scatter.main(["--device", "cpu"])
