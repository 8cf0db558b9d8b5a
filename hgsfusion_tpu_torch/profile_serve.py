"""Where one full-width flagship frame spends its device time.

    python -m hgsfusion_tpu_torch.profile_serve [--view {gather,polar} | --cfg_file <yaml>]
        [--frames 3] [--out profile.json]

Serves the flagship frame (``configs/hgsfusion_vod_pallas.yaml``, the gather
view, or with ``--view polar`` ``configs/hgsfusion_vod_polar.yaml``, in bf16,
random weights from seed 0, the synthetic flagship batch; with
``--cfg_file`` that config, e.g. ``configs/hgsfusion_tj4d_pallas.yaml``, on
the flagship batch at its image size with the synthetic trees' intrinsics,
``datasets/synthetic.py::make_calib``) under
``torch.profiler`` on the card and prints, per frame: device time by serve
stage, the kernels with the most device time, and the device's busy share
of the profiled wall time. The profiler slows the host side, so the busy
share under it is a lower bound of the unprofiled one. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from .config import load_config, model_config_from_yaml, vod_pallas_config, vod_polar_config
from .datasets.synthetic import make_calib
from .models.detector import HGSFusionModel
from .synthetic import flagship_batch

STAGES = ("backbone", "view_transform", "radar_branch", "fusion_head", "post_process")


def _device_us(event, self_only: bool) -> float:
    name = "self_device_time_total" if self_only else "device_time_total"
    old = "self_cuda_time_total" if self_only else "cuda_time_total"
    return float(getattr(event, name, getattr(event, old, 0.0)))


def profile_frames(model, batch, frames: int):
    def frame():
        with torch.inference_mode():
            b = model.batch_to_device(batch)
            with record_function("backbone"):
                feats = model.image_features(b)
            with record_function("view_transform"):
                image_bev = model.view_transform(feats, b)
            with record_function("radar_branch"):
                radar_bev = model.radar_branch(b)
            with record_function("fusion_head"):
                preds = model.fusion_and_head(image_bev, radar_bev)
            with record_function("post_process"):
                model.post_process(preds)

    frame()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    # a stage's host-side range sums the device time of the kernels it launched
    stage_ms = {e.key: _device_us(e, False) / 1e3 / frames for e in events
                if e.key in STAGES and e.device_type == DeviceType.CPU}
    # device-side entries are the kernels and copies, plus the stage ranges'
    # device-side spans, which are left out
    ops = sorted(((e.key, _device_us(e, True) / 1e3 / frames, e.count // frames)
                  for e in events if e.device_type == DeviceType.CUDA and e.key not in STAGES),
                 key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in ops)
    return {
        "frames": frames,
        "wall_ms_per_frame": wall_s * 1e3 / frames,
        "device_busy_ms_per_frame": busy_ms,
        "device_busy_share": busy_ms / (wall_s * 1e3 / frames),
        "device_ops_per_frame": sum(n for _, _, n in ops),
        "stage_device_ms": {s: stage_ms.get(s, 0.0) for s in STAGES},
        "top_ops": [{"op": k, "device_ms": ms, "calls": n} for k, ms, n in ops[:25]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--view", choices=("gather", "polar"), default="gather",
                    help="the view transform: vod_pallas (gather) or vod_polar")
    ap.add_argument("--cfg_file", help="serve this config instead (overrides --view)")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    if args.cfg_file:
        cfg = model_config_from_yaml(load_config(args.cfg_file))
        batch = flagship_batch(cfg, cam_to_img=make_calib(cfg.image_size)["P2"])
    else:
        cfg = vod_polar_config() if args.view == "polar" else vod_pallas_config()
        batch = flagship_batch(cfg)
    model = HGSFusionModel(cfg, device="cuda", seed=0)
    result = profile_frames(model, batch, args.frames)
    result["view"] = cfg.f2v_view
    result["config"] = args.cfg_file
    result["card"] = torch.cuda.get_device_name(0)
    print(json.dumps({k: v for k, v in result.items() if k != "top_ops"}))
    print("kernels by device time per frame:")
    for row in result["top_ops"]:
        print(f"  {row['device_ms']:9.3f} ms  x{row['calls']:<5d} {row['op'][:100]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
