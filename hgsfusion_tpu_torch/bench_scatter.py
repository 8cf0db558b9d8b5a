"""Row scatter-add benchmark: the port's counterpart of
``_bench_scatter_pallas.py::main``, on one CUDA device.

    python -m hgsfusion_tpu_torch.bench_scatter [--cases g8 g4 g8/2 g4/2]
        [--iters 8]

The f2v training backward scatters about 3.17 M cotangent rows into the
quad source maps. For each of the TPU script's four tables (``CASES``:
rows x channels) and the same N, drawn by the same windowed index generator
(``make_inputs``: every tile of 2048 updates lands inside one window of
2048 table rows, numpy ``default_rng(0)``), it prints the mean device time
per call, over ``--iters`` back-to-back calls after a warm-up, of

- the library scatter: ``index_add_`` into a zeroed bf16 table (the
  counterpart of ``xla_scatter``);
- the library outer + scatter: the update rows built as ``w4 (x) ct`` in
  bf16, then ``index_add_`` (``xla_scatter_outer``);
- the kernel: ``ops/row_scatter.py::row_scatter_add`` with its binning
  (``pallas_scatter``), and beside it the binning and the kernel alone;
- the kernel after the outer product is built (``pallas_scatter_outer``'s
  function by way of ``pallas_scatter``'s).

The TPU script's "PRODUCTION rows/planes" lines time the sampler's backward
kernels (K2); the port times that kernel, ``quad_sample_bwd``, in
``chip_smoke.py``'s kernel_vs_plain_bwd phase, so this script leaves them
out. Every number it prints is measured on the device it runs on.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .ops import row_scatter

N = 3_174_400
TILE = 2048
N_PAD = ((N + TILE - 1) // TILE) * TILE
ITERS = 8
# (name, table rows, channels): _bench_scatter_pallas.py's CASES
CASES = [
    ("g8", 16048, 768),
    ("g4", 63056, 256),
    ("g8/2", 16048, 384),
    ("g4/2", 63056, 128),
]


def make_inputs(p: int, cq: int, device):
    """``_bench_scatter_pallas.py::make_inputs``: indices (N_PAD,) int32,
    update rows (N_PAD, cq) bf16, cotangent rows (N_PAD, cq // 4) bf16 and
    tap weights (N_PAD, 4) bf16, drawn in that order from
    ``default_rng(0)`` (in f32, then cast), on ``device``."""
    rng = np.random.default_rng(0)
    win = min(2048, p)
    base = rng.integers(0, p - win + 1, size=(N_PAD // TILE, 1))
    jitter = rng.integers(0, win, size=(N_PAD // TILE, TILE))
    idx = (base + jitter).reshape(-1).astype(np.int32)

    def bf16(a):
        return torch.from_numpy(a).to(device).to(torch.bfloat16)

    upd = bf16(rng.standard_normal((N_PAD, cq), dtype=np.float32))
    ct = bf16(rng.standard_normal((N_PAD, cq // 4), dtype=np.float32))
    w4 = bf16(rng.random((N_PAD, 4), dtype=np.float32))
    return torch.from_numpy(idx).to(device), upd, ct, w4


def library_scatter(idx, upd, p: int):
    return torch.zeros((p, upd.shape[1]), dtype=upd.dtype, device=upd.device).index_add_(
        0, idx, upd)


def outer_rows(ct, w4):
    """The update rows of the quad backward, ``[w0 ct | w1 ct | w2 ct | w3 ct]``."""
    return (w4[:, :, None] * ct[:, None, :]).reshape(ct.shape[0], -1)


def device_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls after
    one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run_case(name: str, p: int, cq: int, device, iters: int = ITERS) -> dict:
    idx, upd, ct, w4 = make_inputs(p, cq, device)
    bins = row_scatter.row_scatter_bins(idx, p)
    timings = {
        "library_scatter": lambda: library_scatter(idx, upd, p),
        "library_outer_scatter": lambda: library_scatter(idx, outer_rows(ct, w4), p),
        "kernel": lambda: row_scatter.row_scatter_add(idx, upd, p),
        "binning": lambda: row_scatter.row_scatter_bins(idx, p),
        "kernel_only": lambda: row_scatter.row_scatter_add_kernel(upd, bins, p),
        "outer_kernel": lambda: row_scatter.row_scatter_add(idx, outer_rows(ct, w4), p),
    }
    out = {"case": name, "table": [p, cq], "rows": N_PAD}
    for key, fn in timings.items():
        ms = device_ms(fn, iters)
        out[f"{key}_ms"] = ms
        print(f"{name} (P={p} CQ={cq}): {key:22s} {ms:8.3f} ms "
              f"({ms * 1e6 / N_PAD:.2f} ns/row)", flush=True)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=[c[0] for c in CASES],
                    choices=[c[0] for c in CASES])
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("bench_scatter times CUDA kernels: it needs a CUDA device")
    return [run_case(name, p, cq, device, args.iters)
            for name, p, cq in CASES if name in args.cases]


if __name__ == "__main__":
    main()
