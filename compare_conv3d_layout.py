#!/usr/bin/env python3
"""Time the dense 3-D convolutions of BEVFusion's VoxelBackBone8x stage 1 on
the card, forward and backward, f32 with TF32 off: cuDNN's autograd in two
memory layouts against the port's route (``conv3d_ndhwc``).

    python3 compare_conv3d_layout.py [--out results.json]

The shapes are ``configs/bevfusion_vod.yaml``'s (a 51 x 320 x 320 grid):
``conv_input`` (17 -> 16 channels), ``conv1`` (16 -> 16) and ``conv2``'s
strided down (16 -> 32, stride 2). Each is timed by CUDA events, forward and
forward + backward (input and weight gradients of a random cotangent), with
the activation as the port keeps it (channels-last memory, a permuted NCDHW
view: ``channels_last``), made contiguous NCDHW first (``ncdhw``, the copy
counted), and through ``models/voxel_backbone.py::conv3d_ndhwc`` (``port``:
cuDNN's forward and input gradient, the weight gradient one product a kernel
tap), whose gradients are held to ``channels_last``'s (within 1e-4 of each
one's largest); cuDNN's autotuner off (the default) and on (``benchmark``).
Prints one JSON line a case and the card's name.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from hgsfusion_tpu_torch.models.voxel_backbone import conv3d_ndhwc

SHAPES = {"conv_input": (17, 16, 1), "conv1": (16, 16, 1), "conv2_down": (16, 32, 2)}
GRID = (51, 320, 320)


def timed(fn, iters: int = 3, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def case(name, cin, cout, stride, layout: str):
    gen = torch.Generator(device="cuda").manual_seed(0)
    x_cl = torch.randn((1,) + GRID + (cin,), device="cuda", generator=gen)  # NDHWC memory
    w_sp = torch.randn((cout, 3, 3, 3, cin), device="cuda", generator=gen) / (27 * cin) ** 0.5
    s3, p3 = (stride,) * 3, (1, 1, 1)
    out = [(n + 2 - 3) // stride + 1 for n in GRID]
    g = torch.randn([1] + out + [cout], device="cuda", generator=gen)

    def run(grad: bool):
        x = x_cl.detach().requires_grad_(grad)
        w = w_sp.detach().requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            if layout == "port":
                y = conv3d_ndhwc(x, w, s3, p3)
            else:
                xv = x.permute(0, 4, 1, 2, 3)
                xv = xv.contiguous() if layout == "ncdhw" else xv
                y = F.conv3d(xv, w.permute(0, 4, 1, 2, 3), None, s3, p3).permute(0, 2, 3, 4, 1)
        if grad:
            y.backward(g)
            return x.grad, w.grad
        return y

    row = {"conv": name, "layout": layout, "benchmark": torch.backends.cudnn.benchmark,
           "fwd_ms": timed(lambda: run(False)), "fwd_bwd_ms": timed(lambda: run(True))}
    return row, run(True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        for name, (cin, cout, stride) in SHAPES.items():
            ref = None
            for layout in ("channels_last", "ncdhw", "port"):
                row, grads = case(name, cin, cout, stride, layout)
                if ref is None:
                    ref = grads
                row["grad_err_over_max"] = [float((a - b).abs().max() / b.abs().max())
                                            for a, b in zip(grads, ref)]
                if max(row["grad_err_over_max"]) > 1e-4:
                    raise AssertionError(f"{name} {layout}: gradients off {row}")
                rows.append(row)
                print(json.dumps(rows[-1]), flush=True)
                del grads
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
