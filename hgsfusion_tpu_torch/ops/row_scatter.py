"""The row scatter-add kernel (``csrc/row_scatter_add.cu``) and its glue.

Counterpart of the TPU prototype ``_bench_scatter_pallas.py::pallas_scatter``:
``out[idx[j], :] += rows[j, :]`` into a zeroed (num_rows, C) table, the
second half of what XLA does for a scatter-add backward once the update
rows are built. The glue bins the updates by destination row
(``row_scatter_bins``: PyTorch's stable sort and search, no host sync); the
kernel gives each destination row and channel chunk to one warp, which sums
the row's updates in f32 in update order and writes the row once, rounded
to the rows' dtype. Indices follow ``jnp.ndarray.at[idx].add``: a negative
index counts from the end, and one outside [-num_rows, num_rows) is
dropped.

A CPU tensor takes the plain version (``row_scatter_add_plain``, an f32
``index_add_`` rounded once); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import native
from .quad_sample import csr_bins

KERNEL = "row_scatter_add"
# launches of the kernel in this process; callers may reset it to 0
launches = {KERNEL: 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _entry():
    fn = getattr(native.load(KERNEL), KERNEL)
    # rows, order, start, out, num_rows, c, dtype, stream
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _destinations(idx, num_rows):
    """Each update's table row (negative indices from the end) and whether
    it lies in the table."""
    dest = torch.where(idx < 0, idx + num_rows, idx)
    return dest, (dest >= 0) & (dest < num_rows)


def row_scatter_bins(idx, num_rows: int):
    """The kernel's bins: ``order`` (N,) int32, the updates sorted by
    destination row, stable in update order, those outside the table last
    (under the key ``num_rows``); ``start`` (num_rows + 1,) int32, each
    row's run in ``order`` (``start[-1]`` counts the updates in the
    table). No step reads back to the host."""
    dest, keep = _destinations(idx, num_rows)
    return csr_bins(torch.where(keep, dest, num_rows), num_rows)


def _check(idx, rows, num_rows):
    if rows.dim() != 2 or idx.shape != (rows.shape[0],):
        raise ValueError(f"{KERNEL}: bad shapes idx {tuple(idx.shape)} rows {tuple(rows.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{KERNEL}: idx must be int32 or int64, got {idx.dtype}")
    if not 0 <= num_rows < 2**31 - 1 or rows.shape[0] >= 2**31:
        raise ValueError(f"{KERNEL}: {num_rows} table rows, {rows.shape[0]} updates exceed int32")
    if idx.device != rows.device:
        raise ValueError(f"{KERNEL}: idx on {idx.device}, rows on {rows.device}")


def row_scatter_add_kernel(rows, bins, num_rows: int):
    """Launch the kernel: ``rows`` (N, C) CUDA tensor, ``bins`` =
    ``row_scatter_bins(idx, num_rows)`` -> (num_rows, C) in ``rows``'s
    dtype."""
    if rows.device.type != "cuda":
        raise ValueError(f"{KERNEL} needs CUDA tensors, got {rows.device}")
    if rows.dtype not in _DTYPE_CODES:
        raise TypeError(f"{KERNEL}: unsupported dtype {rows.dtype}")
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError(f"{KERNEL}: rows must be contiguous and 16-byte aligned")
    order, start = bins
    for arg, t, length in (("order", order, rows.shape[0]), ("start", start, num_rows + 1)):
        if t.dtype != torch.int32 or t.device != rows.device or not t.is_contiguous():
            raise ValueError(f"{KERNEL}: bins {arg} must be contiguous int32 on {rows.device}")
        if t.shape != (length,):
            raise ValueError(f"{KERNEL}: bad shapes bins {arg} {tuple(t.shape)}, want ({length},)")
    out = torch.empty((num_rows, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    err = _entry()(rows.data_ptr(), order.data_ptr(), start.data_ptr(), out.data_ptr(),
                   num_rows, rows.shape[1], _DTYPE_CODES[rows.dtype],
                   torch.cuda.current_stream(rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {err}")
    launches[KERNEL] += 1
    return out


def row_scatter_add(idx, rows, num_rows: int):
    """``out[idx[j]] += rows[j]`` into a zeroed (num_rows, C) table, in
    ``rows``'s dtype: each row's updates summed in f32 and rounded once.
    ``idx`` (N,) int32 or int64; negative indices count from the end, and
    indices outside the table are dropped. CUDA tensors launch the kernel
    (after ``row_scatter_bins``), CPU tensors take the plain version."""
    _check(idx, rows, num_rows)
    if rows.device.type == "cpu":
        return row_scatter_add_plain(idx, rows, num_rows)
    return row_scatter_add_kernel(rows.contiguous(), row_scatter_bins(idx, num_rows), num_rows)


def row_scatter_add_plain(idx, rows, num_rows: int):
    """Plain version of ``row_scatter_add``, same arguments: an f32
    ``index_add_`` of the rows that land in the table, rounded once."""
    _check(idx, rows, num_rows)
    dest, keep = _destinations(idx.long(), num_rows)
    out = torch.zeros((num_rows, rows.shape[1]), dtype=torch.float32, device=rows.device)
    out.index_add_(0, dest[keep], rows[keep].float())
    return out.to(rows.dtype)
