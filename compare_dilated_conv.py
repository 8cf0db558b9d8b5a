#!/usr/bin/env python3
"""Time the depth head's dilated 3x3 convolutions three ways on one NVIDIA GPU.

    python3 compare_dilated_conv.py

The ASPP of ``models/resnet.py::DeepLabClassifier`` runs three 3x3
convolutions of layer4 (2048 -> 256 channels at 65x242, the VoD gather
image's /8 map) with dilations 12, 24 and 36, in bf16. For each rate this
prints, as one JSON line, the forward and the forward + weight-gradient
times (CUDA events, the mean of a few calls after a warm-up) of: cuDNN on
the channels-last view the port's ``layers.conv_nhwc`` passes it; cuDNN on
NCHW memory; and the port's ``resnet.dilated_conv3x3`` (nine shifted
``matmul_f32`` products, f32 sums rounded once), with each one's largest
difference from the first. The first line is the card's name and power
limit. Needs a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from hgsfusion_tpu_torch.models.resnet import dilated_conv3x3

SHAPE, OUT, RATES = (1, 65, 242, 2048), 256, (12, 24, 36)


def ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("compare_dilated_conv: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(SHAPE, device=dev, generator=g).to(torch.bfloat16)  # NHWC
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    w0 = (torch.randn((OUT, SHAPE[-1], 3, 3), device=dev, generator=g) * 0.01).to(torch.bfloat16)
    forms = {
        "channels_last": lambda w, r: F.conv2d(x.permute(0, 3, 1, 2), w, None, 1, r, r),
        "nchw": lambda w, r: F.conv2d(x_nchw, w, None, 1, r, r),
        "shifted_matmul": lambda w, r: dilated_conv3x3(x, w, r, torch.bfloat16).permute(
            0, 3, 1, 2),
    }
    for r in RATES:
        ref = forms["channels_last"](w0, r).float()
        row = {"rate": r}
        for name, fn in forms.items():
            wg = w0.detach().requires_grad_()
            row[name] = {
                "fwd_ms": ms(lambda: fn(w0, r)),
                "fwd_wgrad_ms": ms(lambda: fn(wg, r).float().sum().backward(), iters=3),
                "max_abs_diff": float((fn(w0, r).float() - ref).abs().max()),
            }
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
