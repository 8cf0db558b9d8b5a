#!/usr/bin/env python3
"""Time edited copies of the fused sampler + reduce kernel on one NVIDIA GPU.

    python3 tune_quad_reduce.py '{"name": {"a snippet of the source": "its replacement"}, ...}'

Each variant is ``hgsfusion_tpu_torch/csrc/quad_sample_reduce.cu`` with each
snippet (which must occur exactly once; an identifier names a ``constexpr
int`` constant and takes a value instead) replaced, built with ``nvcc``
into ``_build/tune/`` under the package, all at once, the ptxas report of
its bf16 kernels printed. At the flagship gather groups (both VoD maps,
the flagship grid's (u, v) read in place, K (256, 128) and its bias from
``compare_kernels_parent.py``'s seed) it prints P3-q8's (int8 maps, the
scales folded into K) and P3's (bf16 maps) device time for the committed
kernel and each variant (``chip_smoke.graph_ms``, two passes, the second
in reverse order), and whether each variant's output equals the committed
kernel's bit for bit. An edit that drops work (the products, the gathers'
bytes, the stores) gives the time of what is left, not a kernel to keep.
Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys

import torch

import chip_smoke as cs
from hgsfusion_tpu_torch.ops import library
from hgsfusion_tpu_torch.ops.grid_sample import quantize_per_channel_int8
from tune_quad_bwd import build

ENTRIES = (library.REDUCE_Q8_KERNEL, library.REDUCE_KERNEL)


def flagship_calls(dev):
    """{entry: (uv, groups, kmat, bias)}: P3-q8's and P3's flagship inputs."""
    gen = torch.Generator().manual_seed(5)
    uv = cs.flagship_grid(dev)[..., 0:2]
    maps = [torch.randn(shape, generator=gen).to(dev) for shape in cs.FLAGSHIP_SHAPES.values()]
    qs = [quantize_per_channel_int8(m) for m in maps]
    csum = sum(q.shape[-1] for q, _ in qs)
    kernel = (torch.randn((csum, cs.REDUCE_O), generator=gen) * csum ** -0.5).to(dev)
    bias = torch.randn(cs.REDUCE_O, generator=gen).to(dev)
    kq = (kernel * torch.cat([s for _, s in qs])[:, None]).to(torch.bfloat16).contiguous()
    return {library.REDUCE_Q8_KERNEL: (uv, cs.reduce_groups([q for q, _ in qs]), kq, bias),
            library.REDUCE_KERNEL: (uv, cs.reduce_groups([m.to(torch.bfloat16) for m in maps]),
                                    kernel.to(torch.bfloat16).contiguous(), bias)}


def launch(fn, uv, groups, kmat, bias):
    """One launch of a variant's C entry, as ``library._launch_reduce``."""
    n, per_frame, stride = library.uv_rows(library.REDUCE_KERNEL, uv, groups[0][0].shape[0])
    o = kmat.shape[1]
    out = torch.empty((n, o), dtype=kmat.dtype, device=kmat.device)
    g = len(groups)
    maps = (library._P * g)(*(f.data_ptr() for f, _ in groups))
    hs, ws, cs_ = ((library._I * g)(*(f.shape[i] for f, _ in groups)) for i in (1, 2, 3))
    offs = (library._I * g)(*(int(k) for _, k in groups))
    err = fn(uv.data_ptr(), stride, n, per_frame, maps, hs, ws, cs_, offs, g, kmat.data_ptr(),
             bias.data_ptr(), out.data_ptr(), o, library.DTYPE_CODES[kmat.dtype],
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cudaError {err}")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("tune_quad_reduce: no CUDA device", file=sys.stderr)
        return 2
    fns = build(json.loads(argv[0]), "quad_sample_reduce", ENTRIES, "bfloat16")
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    for entry, args in flagship_calls(dev).items():
        ops = {"committed": lambda a=args, e=entry: library._launch_reduce(e, *a)}
        ops.update({name: (lambda a=args, f=f[entry]: launch(f, *a)) for name, f in fns.items()})
        ref = ops["committed"]()
        row = {"entry": entry, "equal": {name: bool(torch.equal(op(), ref))
                                         for name, op in ops.items() if name != "committed"},
               "ms": {}}
        for order in (list(ops), list(ops)[::-1]):
            for name in order:
                row["ms"].setdefault(name, []).append(cs.graph_ms(ops[name], iters=10,
                                                                  replays=2))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
