"""End-to-end inference benchmark of the port on one CUDA device (the
counterpart of the repository's ``bench.py``).

    python -m hgsfusion_tpu_torch.bench [--<name>] [--batch N] [--realistic]
    python -m hgsfusion_tpu_torch.bench --bevfusion | --transfusion | --centerpoint |
        --centerpoint_res2d | --second | --second_focal | --second_iou | --voxelrcnn |
        --pvrcnn | --pvrcnnpp | --parta2 | --voxelnext | --voxelnext2d [--batch N]

Frames/s of the whole served pipeline (image backbone, view transform,
radar branch, fusion, anchor head, box decode and rotated NMS) through
``HGSFusionModel.serve``, which reads nothing back to the host: the median
of 3 chains of 20 calls on one batch already on the device, each chain
ended by one ``torch.cuda.synchronize()``. The model and batch are
``bench.py``'s: ``configs/hgsfusion_<name>.yaml`` (default ``vod_polar``,
the polar view; ``--vod`` the gather view, ``--tj4d`` TJ4DRadSet) at a
516 x 1936 image in bf16, random weights from seed 0, and the synthetic
flagship batch (``synthetic.flagship_batch``, the counterpart of
``__graft_entry__._vod_flagship``). Random weights score every anchor
under the 0.1 score threshold, so the default, ``--vod`` and ``--tj4d``
lines run NMS on no candidate; only ``--realistic`` exercises it: it
shifts the class head's bias so that about 64 candidates a frame pass the
threshold, the trained-model regime (``calibrate_realistic``).

stdout gets exactly one JSON line, ``{"metric":
"hgsfusion_<name>[_b<N>][_realistic]_e2e_inference", "value", "unit":
"frames/sec/chip", "vs_baseline"}``, with ``vs_baseline`` = frames/s over
3 x ``REF_A100_FPS`` (``bench.py``'s target: three times its estimate of
the reference on an A100). stderr gets the three chains' rates, the device
ms per frame (CUDA events around each chain), the peak device memory, the
card's name and power limit, the kernel launches of the timed calls
(``ops/library.py``'s counts, one line ``# launches {"serve_calls": N,
"counts": {...}}``) and, under ``--realistic``, the boxes kept. Any
failure, no CUDA device included, prints one line with ``"value": 0.0``,
``"error"`` and ``"detail"`` and exits 1: the port never benchmarks on the
CPU.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from .config import load_config, model_config_from_yaml
from .models.detector import HGSFusionModel, resolve_device
from .models.registry import build_network
from .ops import library
from .synthetic import flagship_batch

REF_A100_FPS = 18.0  # bench.py's estimate of the reference on an A100
TARGET_MULTIPLIER = 3.0
CHAINS, CHAIN_LEN = 3, 20
IMAGE_HW = (516, 1936)
# the zoo families' VoD configs (f32) and their MODEL.NAME
ZOO = {"bevfusion": ("configs/bevfusion_vod.yaml", "BEVFusion"),
       "transfusion": ("configs/transfusion_vod.yaml", "TransFusion"),
       "centerpoint": ("configs/centerpoint_vod.yaml", "CenterPoint"),
       "centerpoint_res2d": ("configs/centerpoint_pillarres2d_vod.yaml", "CenterPoint"),
       "second": ("configs/second_vod.yaml", "SECONDNet"),
       "second_focal": ("configs/second_focal_vod.yaml", "SECONDNet"),
       "second_iou": ("configs/second_iou_vod.yaml", "SECONDNetIoU"),
       "voxelrcnn": ("configs/voxelrcnn_vod.yaml", "VoxelRCNN"),
       "pvrcnn": ("configs/pvrcnn_vod.yaml", "PVRCNN"),
       "pvrcnnpp": ("configs/pvrcnnpp_vod.yaml", "PVRCNNPlusPlus"),
       "parta2": ("configs/parta2_vod.yaml", "PartA2Net"),
       "voxelnext": ("configs/voxelnext_vod.yaml", "VoxelNeXt"),
       "voxelnext2d": ("configs/voxelnext2d_vod.yaml", "VoxelNeXt")}


def flagship_config(name: str):
    """``configs/hgsfusion_<name>.yaml`` as ``_vod_flagship`` builds it: a
    516 x 1936 image, bf16 compute; a zoo family's YAML as it is, at that
    image."""
    if name in ZOO:
        return dataclasses.replace(model_config_from_yaml(load_config(ZOO[name][0])),
                                   image_size=IMAGE_HW)
    cfg = model_config_from_yaml(load_config(f"configs/hgsfusion_{name}.yaml"))
    return dataclasses.replace(cfg, image_size=IMAGE_HW, compute_dtype="bfloat16")


def calibrate_realistic(model: HGSFusionModel, batch, target: int = 64) -> float:
    """Shift the class head's bias so that about ``target`` candidates a
    frame pass the 0.1 score threshold (``bench.py::_calibrate_realistic``):
    one forward; the median over the batch of each frame's ``target``-th
    largest logit; one shift that puts it at logit(0.1). Returns the
    shift."""
    with torch.inference_mode():
        logits = model(batch)["cls_preds"].float().reshape(batch["images"].shape[0], -1)
    rank_val = float(np.median(np.sort(logits.cpu().numpy(), axis=1)[:, -target]))
    delta = math.log(0.1 / 0.9) - rank_val
    with torch.no_grad():
        model.dense_head.conv_cls.bias.add_(delta)
    return delta


def metric_name(name: str, batch_size: int, realistic: bool) -> str:
    tag = "" if batch_size == 1 else f"_b{batch_size}"
    if name in ZOO:
        return f"{name}_vod{tag}_e2e_inference"
    return f"hgsfusion_{name}{tag}{'_realistic' if realistic else ''}_e2e_inference"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def run(name: str = "vod_polar", batch_size: int = 1, realistic: bool = False) -> dict:
    """The measurement; returns the stdout line's fields and the stderr
    report's."""
    device = resolve_device("cuda")
    if realistic and name in ZOO:
        raise ValueError(f"--realistic shifts an anchor head's scores; {name} has none")
    cfg = flagship_config(name)
    model = build_network(ZOO[name][1] if name in ZOO else "HGSFusion", cfg, device=device,
                          seed=0)
    batch = model.batch_to_device(flagship_batch(cfg, b=batch_size))
    shift = calibrate_realistic(model, batch) if realistic else None
    out = model.serve(batch)  # warm-up: cuDNN plans, the allocator, the kernels' build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for k in library.launches:
        library.launches[k] = 0
    rates, device_ms = [], []
    for _ in range(CHAINS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(CHAIN_LEN):
            out = model.serve(batch)
        end.record()
        torch.cuda.synchronize()
        rates.append(CHAIN_LEN * batch_size / (time.perf_counter() - t0))
        device_ms.append(start.elapsed_time(end) / (CHAIN_LEN * batch_size))
    launches = dict(library.launches)
    fps = sorted(rates)[len(rates) // 2]
    return {"metric": metric_name(name, batch_size, realistic), "value": fps,
            "unit": "frames/sec/chip", "vs_baseline": fps / (TARGET_MULTIPLIER * REF_A100_FPS),
            "chain_fps": rates, "device_ms_per_frame": device_ms,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(device),
            "card": card_line(), "bias_shift": shift,
            "kept": int(out["valid"].sum()), "frames_per_chain": CHAIN_LEN * batch_size,
            "launches": {"serve_calls": CHAINS * CHAIN_LEN, "counts": launches}}


def parse_argv(argv):
    """bench.py's arguments: ``--batch N`` (or ``--batch=N``),
    ``--realistic``, and the first other ``--<name>``."""
    batch_size, realistic, rest = 1, False, []
    args = iter(argv)
    for a in args:
        if a == "--batch":
            value = next(args, None)
            if value is None:
                raise SystemExit("--batch requires a value (e.g. --batch 2)")
            batch_size = int(value)
        elif a.startswith("--batch="):
            batch_size = int(a.split("=", 1)[1])
        elif a == "--realistic":
            realistic = True
        else:
            rest.append(a)
    name = next((a[2:] for a in rest if a.startswith("--")), None) or "vod_polar"
    return name, batch_size, realistic


def main(argv=None) -> int:
    name, batch_size, realistic = parse_argv(sys.argv[1:] if argv is None else argv)
    line = {"metric": metric_name(name, batch_size, realistic)}
    try:
        res = run(name, batch_size, realistic)
    except Exception as e:  # one legible line, always
        reason = "cuda-unavailable" if not torch.cuda.is_available() else type(e).__name__
        detail = str(e).strip().splitlines()[0] if str(e).strip() else ""
        print(json.dumps({**line, "value": 0.0, "unit": "frames/sec/chip", "vs_baseline": 0.0,
                          "error": reason, "detail": detail[:200]}))
        return 1
    print(f"# {res['card']}; chains {[round(r, 3) for r in res['chain_fps']]} frames/s, "
          f"device {[round(m, 3) for m in res['device_ms_per_frame']]} ms/frame, peak "
          f"{res['peak_memory_bytes']} B", file=sys.stderr)
    print(f"# launches {json.dumps(res['launches'])}", file=sys.stderr)
    if realistic:
        print(f"# realistic regime: bias shift {res['bias_shift']:.4f}, {res['kept']} post-NMS "
              f"boxes in the last batch of {batch_size}", file=sys.stderr)
    print(json.dumps({k: res[k] for k in ("metric", "value", "unit", "vs_baseline")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
