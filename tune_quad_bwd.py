#!/usr/bin/env python3
"""Time variants of the backward sampler kernel's tuning constants on one
NVIDIA GPU.

    python3 tune_quad_bwd.py '{"name": {"CLUSTER": 2, "UNROLL": 8}, ...}'

Each variant is ``hgsfusion_tpu_torch/csrc/quad_sample_bwd.cu`` with the
named ``constexpr int`` constants replaced (``THREADS``, ``MIN_BLOCKS``,
``CLUSTER``, ``UNROLL``), built with ``nvcc`` into ``_build/tune/`` under
the package, all at once. For the flagship maps A and B (bf16, the flagship
frustum geometry) and ``chip_smoke.py``'s hot tile it prints each variant's
kernel time and its largest difference from the plain version, and for A
and B the time of ``quad_bins`` and of its sort. Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import torch

import chip_smoke as cs
from hgsfusion_tpu_torch import native
from hgsfusion_tpu_torch.ops import quad_sample
from hgsfusion_tpu_torch.ops.grid_sample import quad_sample_bwd_plain


def build(variants: dict, source: str = "quad_sample_bwd", entry: str = quad_sample.BWD_KERNEL,
          tag: str = "bfloat16Li2") -> dict:
    """{name: the variant's C entry point ``entry``}, each variant of
    ``csrc/<source>.cu`` compiled at once (the package's headers on the
    include path); prints the ptxas report of the kernels whose mangled
    name holds ``tag``."""
    out = native.BUILD_DIR / "tune"
    out.mkdir(parents=True, exist_ok=True)
    src = (native.CSRC_DIR / f"{source}.cu").read_text()
    procs = {}
    for name, knobs in variants.items():
        text = src
        for k, v in knobs.items():
            text, n = re.subn(rf"constexpr int {k} = \d+;", f"constexpr int {k} = {int(v)};", text)
            if n != 1:
                raise ValueError(f"no constant {k} in {source}.cu")
        cu, lib = out / f"{source}-{name}.cu", out / f"lib{source}-{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([native.nvcc_path(), *native.NVCC_FLAGS,
                                         "-I", str(native.CSRC_DIR), "-o", str(lib), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lines = log.splitlines()
        report = [lines[i + j].strip() for i, line in enumerate(lines)
                  if "Compiling entry function" in line and tag in line
                  for j in (2, 3)]
        print(name, json.dumps(variants[name]), " | ".join(report))
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = quad_sample._ENTRIES[entry][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("tune_quad_bwd: no CUDA device", file=sys.stderr)
        return 2
    fns = build(json.loads(argv[0]))
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    uv = cs.flagship_uv(dev)
    gen = torch.Generator().manual_seed(2)
    cases = {name: (shape, uv, False) for name, shape in cs.FLAGSHIP_SHAPES.items()}
    cases["hot_tile"] = (cs.HOT_SHAPE, cs.hot_coords(dev, gen), True)
    for case, (shape, coords, exact) in cases.items():
        b, h, w, c = shape
        dtype = torch.bfloat16
        idx, w4 = quad_sample.quad_indices(torch.empty(shape, dtype=dtype, device=dev), coords)
        n, padded = idx.numel(), (b, h + 2, w + 2, c)
        g = (torch.randint(-4, 5, (n, c), generator=gen) if exact
             else torch.randn((n, c), generator=gen)).to(dtype).to(dev)
        order, start = quad_sample.quad_bins(idx, w4, padded)
        ref = quad_sample_bwd_plain(g, idx, w4, padded).float()
        row = {}
        for name, fn in fns.items():
            def call(fn=fn):
                out = torch.empty((b, h, w, c), dtype=dtype, device=dev)
                err = fn(g.data_ptr(), order.data_ptr(), start.data_ptr(), w4.data_ptr(),
                         out.data_ptr(), b, h, w, c, 1, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"variant {name}: cudaError {err}")
                return out
            err = float((call().float() - ref).abs().max())
            row[name] = {"kernel_ms": cs.cuda_ms(call, iters=20), "max_abs_err": err}
        print(case, json.dumps(row))
        if not exact:
            key = torch.where((w4 != 0).any(dim=1), idx, b * (h + 2) * (w + 2))
            key16 = (key - 2**15).to(torch.int16)
            print(case, "bins", json.dumps({
                "quad_bins_ms": cs.cuda_ms(lambda: quad_sample.quad_bins(idx, w4, padded)),
                "sort_int16_ms": cs.cuda_ms(lambda: torch.sort(key16, stable=True)),
                "sort_int32_ms": cs.cuda_ms(lambda: torch.sort(key, stable=True))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
