#!/usr/bin/env python3
"""Time variants of the forward sampler kernel's tuning constants on one
NVIDIA GPU.

    python3 tune_quad_fwd.py '{"name": {"THREADS": 256, "UNROLL": 4}, ...}'

Each variant is ``hgsfusion_tpu_torch/csrc/quad_sample.cu`` with the named
``constexpr int`` constants replaced (``THREADS``, ``UNROLL``), built with ``nvcc`` into ``_build/tune/`` under
the package, all at once. At the five maps the kernel samples on the main
paths, in bf16 (the VoD gather maps A and B on the flagship grid's (u, v)
read in place; the polar view's two near-field maps on the near grid's
(u, v) in place and its table q on pass 3's coordinates, 128 channels),
it prints the committed kernel's and each variant's device time without
and with idx/w4 (``chip_smoke.graph_ms``: launches replayed from a CUDA
graph), in two passes (in order, then reversed), and whether each
variant's output, idx and w4 equal the committed kernel's bit for bit.
Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys

import torch

import chip_smoke as cs
from hgsfusion_tpu_torch.ops import quad_sample
from tune_quad_bwd import build


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("tune_quad_fwd: no CUDA device", file=sys.stderr)
        return 2
    fns = build(json.loads(argv[0]), "quad_sample", quad_sample.KERNEL, "bfloat16Li8")
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    polar = cs.polar_coords(dev)
    uv = cs.flagship_grid(dev)[..., 0:2]
    cases = {name: (shape, uv) for name, shape in cs.FLAGSHIP_SHAPES.items()}
    cases.update({name: (shape, polar[name]) for name, shape in cs.POLAR_SHAPES.items()})
    gen = torch.Generator().manual_seed(1)
    for case, (shape, coords) in cases.items():
        f = torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
        b, h, w, c = shape
        n, per_frame, stride = quad_sample._uv_rows(quad_sample.KERNEL, coords, b)
        ref = quad_sample.quad_sample_fwd(f, coords, taps=True)

        def call(fn, taps):
            out = torch.empty((n, c), dtype=f.dtype, device=dev)
            idx = torch.empty(n, dtype=torch.int32, device=dev) if taps else None
            w4 = torch.empty((n, 4), dtype=torch.float32, device=dev) if taps else None
            err = fn(coords.data_ptr(), stride, n, per_frame, f.data_ptr(), b, h, w, c,
                     out.data_ptr(), None if idx is None else idx.data_ptr(),
                     None if w4 is None else w4.data_ptr(), 1,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"cudaError {err}")
            return out, idx, w4

        row = {name: {"bit_equal": all(torch.equal(a, r) for a, r in zip(call(fn, True), ref))}
               for name, fn in fns.items()}
        timed = [("repo", lambda taps: quad_sample.quad_sample_fwd(f, coords, taps=taps))]
        timed += [(name, lambda taps, fn=fn: call(fn, taps)) for name, fn in fns.items()]
        for order in (timed, timed[::-1]):
            for name, fn in order:
                r = row.setdefault(name, {})
                for key, taps in (("ms", False), ("taps_ms", True)):
                    r.setdefault(key, []).append(cs.graph_ms(lambda: fn(taps), iters=50))
        print(case, json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
