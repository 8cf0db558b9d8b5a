#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``hgsfusion_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each of which must pass or the script exits non-zero:

1. card: the ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` of every CUDA kernel (one process per source, all
   started together);
3. kernel vs plain: ``quad_sample_fwd`` (the taps computed in the kernel
   from (u, v) read in place, the unpadded map) against its plain PyTorch
   version at both flagship shapes (the flagship frustum grid's (u, v) read
   in place), a small ragged shape with out-of-bounds coords, odd channels,
   a map that is not 16-byte aligned, coordinates on and around every edge
   and coordinates wholly outside the map (all-zero output), in bf16 (atol
   0.04) and f32 (atol 1e-5); the idx and w4 it writes for the backward
   bit for bit against ``quad_indices``, its output without them and
   through the autograd entry bit for bit; the kernel's time with and
   without idx/w4 beside its memory bound, the route's (the autograd entry
   under ``no_grad`` and with the map requiring grad), the plain version's
   and ``F.grid_sample``'s (a yardstick the port never calls);
4. kernel vs plain, backward: ``quad_sample_bwd`` (with its bins,
   ``quad_bins``) against its plain version at the same flagship shapes, the
   ragged shape, a contention shape (every query on one 2x2 patch) and a hot
   tile (most of 1M queries on three pixels of a map of B's size), the last
   two in exact arithmetic and compared bit for bit, in bf16 and f32
   (tolerances at ``bwd_case``); at the flagship shapes two calls compared
   bit for bit, the bins' and the kernel's times and their sum beside the
   bound, the contention statistics, the plain version's time and
   ``aten.grid_sampler_2d_backward``'s (a yardstick);
4a. taps: the fused kernel's own tap computation (``quad_sample_taps``)
   against ``quad_indices`` bit for bit, bf16 and f32, at the flagship grid
   read in place (both maps), ragged coordinates and coordinates on, beside
   and just beyond every edge;
4b. kernel vs plain, fused reduce: ``quad_sample_reduce_fwd`` (the taps
   computed from the grid's (u, v) read in place, both gather groups'
   unpadded maps and the reduce product in one launch, output in the
   compute dtype) against its plain version at the flagship groups (both
   maps, the flagship grid, the (256, 128) reduce kernel, a random bias) in
   bf16 and f32 and a ragged case (three groups, odd channels and outputs,
   222 queries); tolerances at ``reduce_case``; in bf16 also against the
   sampling route a training step takes (``quad_sample_fwd`` +
   ``matmul_f32``) cast to bf16; the kernel's time beside its bound and
   the taps' L2 traffic, that route's, the plain version's
   and the library pair's (``F.grid_sample`` + ``torch.matmul``: no single
   PyTorch call computes the function, so ``library_ms`` is null);
5. small reference: the TINY test model on the card (kernel) against the same
   weights on the CPU (plain sampler), f32 with TF32 off, head outputs and
   post-processed boxes;
6. small reference, training: one training step of the TINY model (its
   backbone's residual scales at 0) on the card (kernels) against the same
   step on the CPU (plain versions), f32 with TF32 off: loss terms,
   gradients, updated parameters and BN statistics (tolerances in
   ``hgsfusion_tpu_torch/train/step_compare.py``);
7. serve: ``configs/hgsfusion_vod_pallas.yaml`` at full width (ResNet-101 at
   516x1936, 320x320x31 voxels, 8192 radar points) with random weights from a
   seed, one warm-up frame, then 3 frames in bf16 with the launch counters at
   0 before and 1 fused launch per frame after (no other launch, no bins
   built); per-stage times, frames/s and peak device memory;
8. train: the same config and batch with its ``gt_boxes``, one warm-up
   training step, then 3 steps with the counters at 0 before and 2 forward
   and 2 backward launches per step after (and 2 bins built); finite
   losses, a positive anchor, the frozen backbone bit-identical, every other
   trainable tensor moved, the backbone's BN statistics moved, no host sync
   in a step; step times, peak memory, loss terms and the device time by
   kernel of one profiled step;
9. kernel vs plain, polar: both kernels (the backward with its bins) against
   their plain versions at the polar view's three maps, 128 channels (the
   two reduced maps sampled by the near-field grid's (u, v) read in place,
   the polar table sampled by pass 3's clamped coordinates, from the
   flagship geometry), bf16 and f32 at the tolerances above, each call's
   time beside its bound (the forward as in 3);
10. small reference, polar: the TINY model with ``F2V.VIEW: polar`` on the
    card against the CPU, as 5, then one training step as 6;
11. polar vs gather: full width, f32, TF32 off, one set of weights: the
    polar image BEV's first ``POLAR_NEAR_COLUMNS`` columns (the exact near
    field) against the gather path's within 2e-3 of its largest value; the
    far field's correlation and relative L2 printed, not gated;
12. serve polar: ``configs/hgsfusion_vod_polar.yaml`` as 7, with 3 forward
    launches per frame (two near-field maps, pass 3) and no fused one;
13. train polar: as 8, with 3 forward, 3 backward and 3 bins per step;
14. small reference, eval loop: the TINY model through
    ``hgsfusion_tpu_torch.tools.test.run_eval`` over a 4-frame synthetic
    VoD tree, on the card (kernel) against the CPU (plain sampler), f32 with
    TF32 off, at a score threshold no two passing scores of a frame sit
    near: the same frame ids, boxes within 1e-4, the result dict within 1e-6;
15. eval: ``configs/hgsfusion_vod_pallas.yaml`` (read with ``load_config``:
    the card's machine has PyYAML, and Pillow for the JPEG images) over a
    16-frame synthetic VoD tree at 516x1936 written in a temporary directory
    (``structured=True``, 2048 radar and 4096 virtual points under the
    config's ``VIRTUAL_POINT_PREFIX``), its infos from the port's
    ``create_infos``, then ``run_eval`` at B=1 with random weights from seed
    0 (``SCORE_THRESH`` lowered so that about 12 candidates of a frame pass:
    random weights score every anchor under 0.1) after one warm-up frame:
    some boxes kept, the counters at 0 before and 1 fused launch per frame
    after (no other launch, no bins), every frame's
    annotations bit-equal to those of ``serve`` on the same collated batch,
    finite recall counts and result dict, every AP in [0, 100]; printed: the
    pipelined and the ``serve``-only ms per frame, the host ms per frame of
    each stage, the evaluation's seconds and peak device memory;
16. eval polar: ``configs/hgsfusion_vod_polar.yaml`` as 15, with 3 forward
    launches per frame;
17. small reference, XLA sampler: the TINY model with
    ``f2v_sampler_kernel="xla"`` on the card against the CPU, as 5 and 6,
    with the kernels launched on the card (1 fused in the served frame, 2
    forward, 2 backward and 2 bins in the step);
18. train CLI: ``configs/hgsfusion_vod.yaml`` (``SAMPLER_KERNEL: xla``, read
    with ``load_config``) at full width through
    ``hgsfusion_tpu_torch.tools.train.main`` over a 16-frame synthetic tree
    (as 15), ``--fix_random_seed --epochs 2 --max_steps 20 --workers 4``:
    the counters at 0 before and 2 forward, 2 backward and 2 bins per step
    after, finite losses, some frame flipped and some frame with a
    ``lidar_aug_matrix`` other than the identity among those fed,
    checkpoints at steps 16 and 20 only; then a resume with ``--max_steps
    4`` from step 20 whose model and optimizer state equal the file bit for
    bit before its first step, ending at step 24 (one step profiled); then
    ``tools.test.main --ckpt_dir ... --max_frames 8`` on step 24, 1 fused
    launch per frame. Printed: steps/s after the first two steps, the
    loader wait per step, the profiled step's device time, each save's and
    the resume's seconds, the checkpoint's bytes and peak device memory;
19. kernel vs plain, scatter: ``row_scatter_add`` (with its binning)
    against ``row_scatter_add_plain`` at the four tables of
    ``_bench_scatter_pallas.py`` (3,174,400 bf16 rows, each tile of 2048
    inside a window of 2048 table rows): random rows (timed: the kernel
    with its binning, the binning, the kernel alone, the plain version and
    ``index_add_``, beside the bound) and integer-valued rows compared bit
    for bit; then a ragged case (37 channels, negative and out-of-range
    indices, one row receiving every update); tolerances at
    ``scatter_case``; every case two calls bit for bit;
20. bench scatter: P5's entry point, ``hgsfusion_tpu_torch.bench_scatter``,
    on BENCH_SCATTER_CASES: the kernel launched 12 times a case;
21. small reference, TJ4D: the TINY TJ4D model (``tiny_tj4d_cut`` of
    ``configs/hgsfusion_tj4d_pallas.yaml``: 4 classes, 8 anchors, 18 point
    features, a 32 x 40 x 6 grid) over a 4-frame synthetic TJ4D tree, card
    vs CPU: two frames served (as 5), one B=2 training step on two
    augmented frames (as 6), the eval loop (as 14);
22. serve TJ4D: ``configs/hgsfusion_tj4d_pallas.yaml`` at full width
    (810x1280, 216 x 248 x 19 voxels) as 7 on ``tj4d_serve_batch``, 1
    fused launch per frame;
23. serve TJ4D polar: ``configs/hgsfusion_tj4d_polar.yaml`` as 22, 3
    forward launches per frame;
24. train CLI, TJ4D: ``configs/hgsfusion_tj4d.yaml`` (``SAMPLER_KERNEL:
    xla``, ``BATCH_SIZE_PER_DEVICE: 2``) through ``tools.train.main`` over a
    16-frame synthetic TJ4D tree, 10 steps across an epoch boundary: 2
    forward, 2 backward and 2 bins per step, checkpoints at steps 8 and 10,
    step 1 profiled; then ``tools.test.main --ckpt_dir`` over 8 frames, 1
    fused launch per frame, TJ4D's result dict with every AP in [0, 100];
25. eval TJ4D polar: ``configs/hgsfusion_tj4d_polar.yaml`` as 15 over a
    16-frame synthetic TJ4D tree, 3 forward launches per frame;
26. small reference, RHGM: the segmentor's tiny preset with either pixel
    decoder (weights from one seed) on a 70 x 100 image, on the card against
    the CPU in f32 with TF32 off: logits and mask logits within
    ``RHGM_TOL``, then ``instance_inference`` (``compare_instances``: labels,
    scores and binary masks rank by rank where the ranks are tie-free, a
    flipped mask pixel only where the CPU's logit lies within ``RHGM_TOL``
    of 0);
27. RHGM: the port's ``tools/generate_hybrid_points.py`` (``main``) on a
    5-frame synthetic VoD tree at 516 x 1936 (2048 radar points a frame):
    ``--mask_source model --model_preset large --pixel_decoder msdeform
    --resize_shortest 1024`` (swin-L Mask2Former on 1024 x 3842, random
    weights from seed 0) with ``--confidence_threshold 0.0``, since random
    weights score no instance near the default 0.5 and the generator would
    do nothing; every frame with virtual and real points; then the
    precomputed source on the first run's masks (``.npz``): the same files
    byte for byte; the VoD dataset (``configs/hgsfusion_vod.yaml``) reads
    them under its ``VIRTUAL_POINT_PREFIX``, 15 wide, virtual rows in every
    frame; then one TJ4D frame (810 x 1280 PNG, 8 radar dims) through the
    model source at the tool's own size: 16 wide. No kernel counter moves.
    Printed per frame: the segmentor's ms (to a device synchronize), the
    masks' copy and the host generator's ms, the masks kept, the virtual and
    real points; frames/s through the tool after the warm-up frame, peak
    device memory, and the segmentor's FLOPs (``torch.utils.flop_counter``)
    over the f32 peak as its bound.

The ``kernels`` line counts each kernel's launches over the main paths
(``MAIN_PATHS``: 7, 8, 12, 13, 15, 16, 18's three runs, 20, 22-25 and 27),
each path's count taken with the counters at 0 just before it; the
forward's row also carries ``route_ms``, its autograd entry's time. The last lines are the
``kernels`` JSON line, the ``nvidia-smi`` line and ``{"ok": true,
"device": {...}}``. Without a CUDA device it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from hgsfusion_tpu_torch import bench_scatter, native
from hgsfusion_tpu_torch.config import (HGSFusionConfig, load_config, model_config_from_yaml,
                                        vod_dataset_config, vod_pallas_config, vod_polar_config)
from hgsfusion_tpu_torch.datasets import build_dataset
from hgsfusion_tpu_torch.datasets.synthetic import (make_calib, make_synthetic_kitti,
                                                    make_synthetic_tj4d)
from hgsfusion_tpu_torch.models.anchors import TargetAssigner
from hgsfusion_tpu_torch.models.detector import HGSFusionModel, post_process
from hgsfusion_tpu_torch.models.frustum import FrustumGridGenerator
from hgsfusion_tpu_torch.models.layers import matmul_f32, resize_bilinear
from hgsfusion_tpu_torch.models.polar_f2v import polar_geometry
from hgsfusion_tpu_torch.ops import quad_sample, row_scatter
from hgsfusion_tpu_torch.ops.grid_sample import quad_sample_bwd_plain, quad_sample_fwd_plain
from hgsfusion_tpu_torch.rhgm.mask2former import Mask2FormerInstance, instance_inference
from hgsfusion_tpu_torch.synthetic import LIDAR_TO_CAM, flagship_batch
from hgsfusion_tpu_torch.tools import generate_hybrid_points as ghp
from hgsfusion_tpu_torch.tools import test as test_cli
from hgsfusion_tpu_torch.tools import train as train_cli
from hgsfusion_tpu_torch.tools.create_infos import create_infos
from hgsfusion_tpu_torch.tools.test import run_eval
from hgsfusion_tpu_torch.train.checkpoint import CheckpointManager
from hgsfusion_tpu_torch.train.optim import FROZEN_PREFIX, build_optimizer
from hgsfusion_tpu_torch.train.step_compare import (GradCapture, compare_steps, perturb_inputs,
                                                    sensitivity, step_record,
                                                    zero_residual_scales)
from hgsfusion_tpu_torch.train.trainer import detections_to_pred_dicts, make_train_step
from hgsfusion_tpu_torch.utils.common import create_logger

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # dense, tensor cores
KERNEL_SOURCES = ["quad_sample", "quad_sample_bwd", "quad_sample_reduce", "row_scatter_add"]
BF16_TOL, F32_TOL = 0.04, 1e-5
F32_U = 2.0 ** -24  # f32 unit round-off
# the two gathers of a frame: layer1 (64 ch at /4), layers 2-4 (192 ch at /8)
FLAGSHIP_SHAPES = {"A": (1, 129, 484, 64), "B": (1, 65, 242, 192)}
FLAGSHIP_QUERIES = 320 * 320 * 31
# the view transform's reduce: sum of the groups' channels (256) to 128
# outputs; the fused kernel against its plain version: f32 order bounds (see
# reduce_case)
REDUCE_O = 128
REDUCE_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
# the optimizer's schedule length in the training phases (a short OneCycle)
TRAIN_TOTAL_STEPS = 100
# the weights of the small training reference: a seed whose step the CPU's
# own probes find well conditioned (step_compare.SENS_CAP)
TRAIN_REF_SEED = 3


def tiny_batch(b: int = 1, n: int = 128):
    """tests/test_model.py::make_tiny_batch with RandomState(0), gt boxes
    included."""
    rng = np.random.RandomState(0)
    pts = np.zeros((b, n, 17), np.float32)
    pts[..., 0] = rng.uniform(0.5, 15.5, (b, n))
    pts[..., 1] = rng.uniform(-7.5, 7.5, (b, n))
    pts[..., 2] = rng.uniform(-2.5, 1.5, (b, n))
    pts[..., 3:15] = rng.randn(b, n, 12).astype(np.float32)
    pts[..., 15] = (rng.rand(b, n) > 0.5).astype(np.float32)
    pts[..., 16] = 1.0
    return {
        "points": pts,
        "points_valid": np.ones((b, n), bool),
        "images": rng.rand(b, 64, 96, 3).astype(np.float32),
        "trans_lidar_to_cam": np.tile(np.array(LIDAR_TO_CAM, np.float32), (b, 1, 1)),
        "trans_cam_to_img": np.tile(np.array(
            [[80.0, 0, 48, 0], [0, 80, 32, 0], [0, 0, 1, 0]], np.float32), (b, 1, 1)),
        "lidar_aug_matrix": np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
        "gt_boxes": np.tile(np.array([[6.0, 1.0, -0.8, 3.9, 1.6, 1.56, 0.3, 1],
                                      [10.0, -2.0, -0.5, 0.8, 0.6, 1.73, -0.5, 2]]
                                     + [[0.0] * 8] * 6, np.float32), (b, 1, 1)),
    }


TINY = HGSFusionConfig(pc_range=(0.0, -8.0, -3.0, 16.0, 8.0, 2.0), voxel_size=(0.5, 0.5, 0.5),
                       image_size=(64, 96), disc_num_bins=16, disc_depth_max=16.0,
                       image_backbone="ResNet50", f2v_sampler_kernel="pallas")
TINY_POLAR = dataclasses.replace(TINY, f2v_view="polar", f2v_sampler_kernel="xla")
TINY_XLA = dataclasses.replace(TINY, f2v_sampler_kernel="xla")
# the polar view's three sampled maps at full width: the two reduced maps
# (128 channels) of the near field, and the polar table q (J = 128 zeta
# nodes, K = 484 + 6 u-nodes) of pass 3
POLAR_SHAPES = {"near_A": (1, 129, 484, 128), "near_B": (1, 65, 242, 128),
                "q": (1, 128, 490, 128)}
# the near field against the gather path: tests/test_polar_f2v.py's bound
NEAR_TOL = 2e-3


def zero_launches():
    for counters in (quad_sample.launches, row_scatter.launches):
        for k in counters:
            counters[k] = 0


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured in a CUDA
    graph, the mean over ``replays`` replays after a warm-up one, so that
    the host's pace of launching them is out of the timing (``cuda_ms``
    times calls as the host launches them). ``fn`` allocates from the graph's
    pool; its host side (a launch counter) runs once, at the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sampler_case(name, features, coords, dtype, tol, timed: bool):
    """``quad_sample_fwd`` (``coords`` read in place, the unpadded map)
    against its plain version on one input, at ``tol``; the idx and w4 it
    writes for the backward against ``quad_indices``' bit for bit; without
    them, and through the autograd entry, the same output bit for bit.
    ``timed``: the kernel's device time with and without idx/w4
    (``graph_ms``; ``calls_ms``: its calls back to back as the host launches
    them), the route (the autograd entry under ``no_grad`` and with the map
    requiring grad), the plain version and ``F.grid_sample``, beside the
    bound with and without idx/w4."""
    f = features.to(dtype)
    b, h, w, c = f.shape
    out, idx, w4 = quad_sample.quad_sample_fwd(f, coords, taps=True)
    bare = quad_sample.quad_sample_fwd(f, coords)[0]
    got = quad_sample.grid_sample_2d_quad_kernel(f, coords)
    torch.cuda.synchronize()
    ref, ref_idx, ref_w4 = quad_sample.quad_sample_fwd_uv_plain(f, coords, taps=True)
    err = float((out.float() - ref.float()).abs().max())
    n, isz = idx.numel(), f.element_size()
    row = {"case": name, "dtype": str(dtype).replace("torch.", ""),
           "shape": [b, h, w, c], "queries": n, "uv_stride": coords.stride(-2),
           "max_abs_err": err, "tol": tol,
           "idx_equal": bool(torch.equal(idx, ref_idx)),
           "w4_equal": bool(torch.equal(w4, ref_w4)),
           "valid_queries": int((w4 != 0).any(dim=1).sum()),
           "bit_equal_without_taps": bool(torch.equal(out, bare)),
           "bit_equal_route": bool(torch.equal(got.reshape(n, c), out))}
    del bare, got, ref, ref_idx, ref_w4
    if timed:
        # each query's (x, y), the map once, the output once; idx and w4 on top
        nbytes = n * 8 + f.numel() * isz + n * c * isz
        ops = 8.0 * n * c  # four multiply-adds a channel
        row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS_PER_S \
            else "operations"
        row["bound_taps_ms"] = max((nbytes + 20 * n) / HBM_BYTES_PER_S,
                                   ops / F32_FLOPS_PER_S) * 1e3
        row["bytes"] = nbytes
        # the kernel's device time (launches replayed from a CUDA graph), and
        # its calls back to back as the host launches them
        row["ms"] = graph_ms(lambda: quad_sample.quad_sample_fwd(f, coords))
        row["taps_ms"] = graph_ms(lambda: quad_sample.quad_sample_fwd(f, coords, taps=True))
        row["calls_ms"] = cuda_ms(lambda: quad_sample.quad_sample_fwd(f, coords), iters=50)
        with torch.no_grad():
            row["route_ms"] = cuda_ms(lambda: quad_sample.grid_sample_2d_quad_kernel(f, coords),
                                      iters=50)
        fg = f.detach().requires_grad_()
        row["route_grad_ms"] = cuda_ms(lambda: quad_sample.grid_sample_2d_quad_kernel(fg, coords),
                                       iters=50)
        row["plain_ms"] = cuda_ms(lambda: quad_sample.quad_sample_fwd_uv_plain(f, coords),
                                  iters=3, warmup=1)
        fmap = f.permute(0, 3, 1, 2).contiguous()
        # grid_sample takes the grid in the map's dtype
        g = coords.reshape(b, -1, coords.shape[-2], 2).to(dtype)
        row["library_ms"] = cuda_ms(lambda: F.grid_sample(
            fmap, g, mode="bilinear", padding_mode="zeros", align_corners=True), iters=50)
        row["bound_fraction"] = row["bound_ms"] / row["ms"]
    print("  " + json.dumps(row))
    if not err <= tol:
        raise AssertionError(f"{name} {row['dtype']}: max error {err} > {tol}")
    for key in ("idx_equal", "w4_equal", "bit_equal_without_taps", "bit_equal_route"):
        if not row[key]:
            raise AssertionError(f"{name} {row['dtype']}: {key} is false")
    return row


def flagship_grid(dev):
    """The flagship frame's sampling grid (1, 320, 320, 31, 3): (u, v, depth
    bin) as the view transform reads it."""
    cfg = vod_pallas_config()
    batch = flagship_batch(cfg)
    gen = FrustumGridGenerator(cfg.grid_size, cfg.pc_range, cfg.disc_cfg, cfg.bev_aug)
    return gen(*(torch.from_numpy(batch[k]).to(dev) for k in
                 ("trans_lidar_to_cam", "trans_cam_to_img")), cfg.image_size,
               bda=torch.from_numpy(batch["lidar_aug_matrix"]).to(dev))


def flagship_uv(dev):
    """The flagship frame's (u, v) sampling grid (1, 320, 320, 31, 2),
    contiguous."""
    return flagship_grid(dev)[..., 0:2].contiguous()


def outside_coords(dev, n: int = 600, seed: int = 13):
    """(2, n, 2) coordinates wholly outside a map of at least 2 x 2 pixels:
    x or y beyond 1.5 in magnitude (more than half the map's span past its
    edge), the other anywhere in -1.3 .. 1.3."""
    g = torch.Generator().manual_seed(seed)
    far = (torch.rand((2, n), generator=g) * 2.5 + 1.5) \
        * torch.where(torch.rand((2, n), generator=g) < 0.5, -1.0, 1.0)
    near = torch.rand((2, n), generator=g) * 2.6 - 1.3
    x_out = torch.rand((2, n), generator=g) < 0.5
    return torch.stack([torch.where(x_out, far, near), torch.where(x_out, near, far)],
                       -1).to(dev)


def unaligned(t):
    """``t``'s values in a contiguous tensor whose data starts one element
    past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return flat.copy_(t.reshape(-1)).view(t.shape)


def phase_kernel_vs_plain(dev):
    """K1 at the VoD gather maps (the flagship grid's (u, v) read in place),
    a ragged case (two frames, 40 channels, coordinates beyond the maps),
    odd channels, a map that is not 16-byte aligned, coordinates on and
    around every edge and coordinates wholly outside the map, bf16 and f32;
    the gather maps and the ragged case timed."""
    uv = flagship_grid(dev)[..., 0:2]
    g = torch.Generator(device="cpu").manual_seed(1)
    cases = [(name, torch.randn(shape, generator=g).to(dev), uv)
             for name, shape in FLAGSHIP_SHAPES.items()]
    ragged = (torch.rand((2, 37, 3, 3), generator=g) * 2.6 - 1.3).to(dev)[..., 0:2]
    cases += [("ragged", torch.randn((2, 11, 17, 40), generator=g).to(dev), ragged),
              ("odd_channels", torch.randn((2, 11, 17, 13), generator=g).to(dev), ragged),
              ("outside", torch.randn((2, 11, 17, 40), generator=g).to(dev),
               outside_coords(dev))]
    cases += [("edges", torch.randn(shape, generator=g).to(dev), edge_coords(dev, shape[1:3]))
              for shape in ((1, 5, 7, 8), (1, 1, 1, 8), (1, 65, 242, 64))]
    rows = []
    for name, feats, coords in cases:
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            rows.append(sampler_case(name, feats, coords, dtype, tol,
                                     timed=name in FLAGSHIP_SHAPES or name == "ragged"))
            if name == "outside" and bool(quad_sample.quad_sample_fwd(
                    feats.to(dtype), coords)[0].any()):
                raise AssertionError(f"outside {dtype}: nonzero output")
        if name == "ragged":
            for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
                rows.append(sampler_case("unaligned", unaligned(feats.to(dtype)), coords,
                                         dtype, tol, timed=False))
    return rows


def contention(idx, w4, padded):
    """Tap adds with a nonzero weight, the pixels that receive any, and the
    most adds one pixel receives."""
    b, hp2, wp2, _ = padded
    taps = torch.cat([idx.long() + o for o in (0, 1, wp2, wp2 + 1)])
    adds = torch.bincount(taps[w4.t().reshape(-1) != 0], minlength=b * hp2 * wp2)
    return {"tap_adds": int(adds.sum()), "pixels_receiving": int((adds > 0).sum()),
            "max_adds_per_pixel": int(adds.max())}


def bwd_case(name, shape, coords, dtype, gen, timed: bool, exact: bool = False):
    """``quad_sample_bwd`` vs its plain version on one input.

    Both sum in f32 (in another order) and round once. f32: atol 1e-5 x
    (1 + max|ref|). bf16: 1e-6 + 2^-7 |ref| (one bf16 rounding) + n u S per
    element, where S is the pixel's sum of |w g| over its n contributions
    (the order bound of an f32 sum, u = 2^-24). ``exact``: small-integer
    cotangents and weights of 1/4, whose sums are exact in f32 whatever the
    order (weights that are multiples of 1/16 keep them exact too): compared
    bit for bit. Every case times the bins and the kernel; ``timed`` also
    compares two calls bit for bit (the kernel uses no atomics) and times
    both together (``ms``, what a training step pays), the plain version and
    the library call, beside the bound and the contention statistics.
    """
    dev = coords.device
    b, h, w, c = shape
    idx, w4 = quad_sample.quad_indices(torch.empty(shape, dtype=dtype, device=dev), coords)
    n = idx.numel()
    padded = (b, h + 2, w + 2, c)
    if exact:
        g = torch.randint(-4, 5, (n, c), generator=gen).to(dtype).to(dev)
    else:
        g = torch.randn((n, c), generator=gen).to(dtype).to(dev)
    bins = quad_sample.quad_bins(idx, w4, padded)
    got = quad_sample.quad_sample_bwd(g, idx, w4, padded, bins)
    torch.cuda.synchronize()
    ref = quad_sample_bwd_plain(g, idx, w4, padded)
    diff = (got.float() - ref.float()).abs()
    stats = contention(idx, w4, padded)
    if exact:
        tol = torch.zeros_like(diff)
    elif dtype == torch.float32:
        tol = torch.full_like(diff, F32_TOL * (1 + float(ref.abs().max())))
    else:
        s_abs = quad_sample_bwd_plain(g.float().abs(), idx, w4.abs(), padded)
        tol = 1e-6 + 2.0 ** -7 * ref.float().abs() + stats["max_adds_per_pixel"] * F32_U * s_abs
    row = {"case": name, "dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
           "queries": n, "max_abs_err": float(diff.max()),
           "max_err_over_tol": float((diff / tol.clamp(min=1e-30)).max()) if not exact else 0.0,
           "bin_ms": cuda_ms(lambda: quad_sample.quad_bins(idx, w4, padded)),
           "kernel_ms": cuda_ms(lambda: quad_sample.quad_sample_bwd(g, idx, w4, padded, bins))}
    if timed:
        again = quad_sample.quad_sample_bwd(g, idx, w4, padded,
                                            quad_sample.quad_bins(idx, w4, padded))
        row["bit_equal_rerun"] = bool(torch.equal(got, again))
        if not row["bit_equal_rerun"]:
            raise AssertionError(f"{name} {row['dtype']}: two calls differ")
        row.update(stats)
        isz = g.element_size()
        valid = int(bins[1][-1])  # queries with a nonzero weight
        # idx and w4 of every query, the cotangent rows with a nonzero
        # weight, the output once
        nbytes = n * (4 + 16) + valid * c * isz + b * h * w * c * isz
        ops = 2.0 * stats["tap_adds"] * c  # an f32 multiply-add per nonzero tap and channel
        row["valid_queries"] = valid
        row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS_PER_S \
            else "operations"
        row["bytes"] = nbytes
        row["ms"] = cuda_ms(lambda: quad_sample.quad_sample_bwd(
            g, idx, w4, padded, quad_sample.quad_bins(idx, w4, padded)))
        row["plain_ms"] = cuda_ms(lambda: quad_sample_bwd_plain(g, idx, w4, padded),
                                  iters=3, warmup=1)
        # the same input gradient from one PyTorch call, on the NCHW map
        fmap = torch.zeros((b, c, h, w), dtype=dtype, device=dev)
        grid = coords.reshape(b, -1, coords.shape[-2], 2).to(dtype)
        gout = g.reshape(b, grid.shape[1], grid.shape[2], c).permute(0, 3, 1, 2).contiguous()
        row["library_ms"] = cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            gout, fmap, grid, 0, 0, True, [True, False]))
    print("  " + json.dumps(row))
    if not bool((diff <= tol).all()):
        raise AssertionError(f"{name} {row['dtype']}: max error {row['max_abs_err']} "
                             f"over its tolerance")
    return row


# hot tile: a map of B's size with H - 1 and W - 1 powers of 2, so that
# quarter-pixel coords normalize exactly and every weight is a multiple of 1/16
HOT_SHAPE = (1, 65, 257, 192)


def hot_coords(dev, gen, n: int = 1 << 20):
    """(1, n, 2) coords on the quarter-pixel grid of HOT_SHAPE: 90% within
    a quarter pixel of three points, the rest spread over the map and beyond
    it."""
    _, h, w, _ = HOT_SHAPE
    lo, hi = torch.tensor([-2.0, -2.0]), torch.tensor([w + 1.0, h + 1.0])
    px = lo + torch.floor(torch.rand((n, 2), generator=gen) * (hi - lo) * 4) / 4
    points = torch.tensor([[120.5, 30.25], [121.0, 31.0], [7.75, 60.5]])
    k = n * 9 // 10
    px[:k] = (points[torch.randint(0, 3, (k,), generator=gen)]
              + torch.randint(-1, 2, (k, 2), generator=gen) / 4)
    return (px / torch.tensor([w - 1.0, h - 1.0]) * 2 - 1).reshape(1, n, 2).to(dev)


def phase_kernel_vs_plain_bwd(dev):
    uv = flagship_uv(dev)
    gen = torch.Generator(device="cpu").manual_seed(2)
    rows = []
    for name, shape in FLAGSHIP_SHAPES.items():
        rows.append(bwd_case(name, shape, uv, torch.bfloat16, gen, timed=True))
        rows.append(bwd_case(name, shape, uv, torch.float32, gen, timed=False))
    coords = (torch.rand((2, 37, 3, 2), generator=gen) * 2.6 - 1.3).to(dev)
    # contention: 65,536 queries at the center of one 2x2 patch of a 9x9
    # map (normalized -0.375 is pixel 2.5 exactly), all weights 1/4; hot
    # tile: most queries on a few pixels, weights multiples of 1/16; both
    # exact in f32 whatever the order
    centre = torch.full((1, 256, 256, 2), -0.375, device=dev)
    hot = hot_coords(dev, gen)
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(bwd_case("ragged", (2, 11, 17, 40), coords, dtype, gen, timed=False))
        rows.append(bwd_case("contention", (1, 9, 9, 64), centre, dtype, gen, timed=False,
                             exact=True))
        rows.append(bwd_case("hot_tile", HOT_SHAPE, hot, dtype, gen, timed=False, exact=True))
    return rows


def reduce_groups(maps):
    """The fused kernel's (map, k_off) of each map, as
    ``FrustumToVoxelMultiScale.accumulate`` builds them."""
    groups, off = [], 0
    for f in maps:
        groups.append((f, off))
        off += f.shape[-1]
    return groups


def sampling_route(uv, groups, kmat, bias):
    """The same function by the route a training step takes: ``quad_sample_fwd``
    per group (uv read in place, the unpadded map), ``matmul_f32``, ``add_``
    onto the bias; f32, unrounded."""
    out = bias.expand(uv.numel() // 2, kmat.shape[1]).clone()
    for f, k_off in groups:
        out.add_(matmul_f32(quad_sample.quad_sample_fwd(f, uv)[0],
                            kmat[k_off:k_off + f.shape[-1]]))
    return out


def library_pair(maps, coords, kmat, bias):
    """The same function from library calls, ``F.grid_sample`` and
    ``torch.matmul`` per group, then the cast (no single PyTorch call
    computes it)."""
    b = coords.shape[0]
    grid = coords.reshape(b, -1, coords.shape[-2], 2).to(kmat.dtype)
    out, k_off = bias, 0
    for f in maps:
        c = f.shape[-1]
        s = F.grid_sample(f.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True)
        out = out + torch.matmul(s.flatten(2).transpose(1, 2),
                                 kmat[k_off:k_off + c]).reshape(-1, kmat.shape[1])
        k_off += c
    return out.to(kmat.dtype)


def reduce_case(name, maps, uv, o, dtype, gen, timed: bool):
    """``quad_sample_reduce_fwd`` vs its plain version on one input, both
    in ``dtype``; ``uv`` is read in place.

    Both sum the products in f32 in another order: f32 within REDUCE_RTOL x
    (1 + max|ref|), the order bound of a sum of sum(c) + 1 terms with room.
    bf16: the plain version combines the taps in bf16 (a rounding after each
    of 4 products and 3 sums, ``quad_sample_fwd_plain``), the kernel in f32
    with one rounding, so it also allows 8 roundings of 2^-8 of the taps'
    magnitude S = sum |w t| through |K|: 2^-5 (S @ |K|); and both round their
    f32 sums once to bf16, which may put them one unit in the last place
    apart: 2^-7 |ref|. The sampling route with the kernel's own rounding of
    the taps (``quad_sample_fwd`` + ``matmul_f32``), cast to bf16, is held
    at REDUCE_RTOL x (1 + max|ref|) + 2^-7 |ref|. ``timed``: the kernel,
    that route, the plain version and the library pair, beside the bound."""
    dev = uv.device
    maps = [m.to(dtype) for m in maps]
    groups = reduce_groups(maps)
    csum = sum(m.shape[-1] for m in maps)
    kmat = (torch.randn((csum, o), generator=gen) * csum ** -0.5).to(dtype).to(dev)
    bias = torch.randn(o, generator=gen).to(dev)
    n = uv.numel() // 2
    got = quad_sample.quad_sample_reduce_fwd(uv, groups, kmat, bias)
    torch.cuda.synchronize()
    ref = quad_sample.quad_sample_reduce_plain(uv, groups, kmat, bias)
    rtol = REDUCE_RTOL[dtype]
    tol = rtol * (1 + float(ref.float().abs().max()))
    row = {"case": name, "dtype": str(dtype).replace("torch.", ""),
           "maps": [list(m.shape) for m in maps], "o": o, "queries": n,
           "out_dtype": str(got.dtype).replace("torch.", "")}
    if got.dtype != dtype or got.shape != (n, o):
        raise AssertionError(f"{name}: output {got.dtype} {tuple(got.shape)}")
    diff = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        ratio = float(diff.max()) / tol
    else:
        mag = torch.zeros_like(diff)
        for f, k_off in groups:
            idx, w4 = quad_sample.quad_indices(f, uv)
            fp = F.pad(f, (0, 0, 1, 1, 1, 1)).contiguous()
            s_abs = quad_sample_fwd_plain(fp.float().abs(), idx, w4.abs())
            mag.add_(s_abs @ kmat[k_off:k_off + f.shape[-1]].float().abs())
            del s_abs, fp
        ulp = 2.0 ** -7 * ref.float().abs()
        ratio = float((diff / (tol + 2.0 ** -5 * mag + ulp)).max())
        del mag, ulp
        route = sampling_route(uv, groups, kmat, bias)
        same = (got.float() - route.to(dtype).float()).abs()
        row["max_abs_err_same_rounding"] = float(same.max())
        row["same_rounding_over_tol"] = float((same / (tol + 2.0 ** -7 * route.abs())).max())
        del route, same
    row.update(max_abs_err=float(diff.max()), max_err_over_tol=ratio,
               finite=bool(torch.isfinite(got).all()))
    del diff, ref
    if timed:
        isz = kmat.element_size()
        # uv (x, y) read once, each map and K once, the output written once
        nbytes = (n * 8 + sum(m.numel() * isz for m in maps) + kmat.numel() * isz + o * 4
                  + n * o * isz)
        ops = 2.0 * n * csum * o
        peak = F32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
        row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / peak else "operations"
        row["bytes"], row["ops"] = nbytes, ops
        # computed, not measured: the four tap rows of every query and group
        # that pass through L2, beside the bound
        row["computed_l2_tap_bytes"] = 4 * csum * isz * n
        row["ms"] = cuda_ms(lambda: quad_sample.quad_sample_reduce_fwd(uv, groups, kmat, bias))
        row["sampling_route_ms"] = cuda_ms(lambda: sampling_route(uv, groups, kmat, bias))
        row["plain_ms"] = cuda_ms(lambda: quad_sample.quad_sample_reduce_plain(
            uv, groups, kmat, bias), iters=3, warmup=1)
        # no single PyTorch call computes this function: library_ms stays null,
        # the pair of calls that does is timed beside it
        row["library_ms"] = None
        row["library_pair"] = "F.grid_sample + torch.matmul per group, cast"
        row["library_pair_ms"] = cuda_ms(lambda: library_pair(maps, uv, kmat, bias))
    print("  " + json.dumps(row))
    if not row["finite"] or not ratio <= 1.0 or not row.get("same_rounding_over_tol", 0) <= 1.0:
        raise AssertionError(f"{name} {row['dtype']}: max error {row['max_abs_err']} over its "
                             f"tolerance")
    return row


def edge_coords(dev, sizes, n: int = 4096, seed: int = 11):
    """(1, M, 2) coordinates on and around every edge of maps of ``sizes``
    pixels: exactly -1 and 1, one f32 step either side, one and half a
    pixel in and out, far beyond, crossed in x and y; then ``n`` random
    ones."""
    one = torch.tensor(1.0)
    special = [torch.tensor([-1.0, 1.0, 0.0, -1.5, 1.5, -3.0, 3.0, 1e6, -1e6])]
    special += [torch.nextafter(v, 2 * v)[None] for v in (-one, one)]
    special += [torch.nextafter(v, -2 * v)[None] for v in (-one, one)]
    for size in sizes:
        step = 2.0 / max(size - 1, 1)
        special.append(torch.tensor([-1 + step, 1 - step, -1 - step, 1 + step,
                                     -1 + step / 2, 1 - step / 2]))
    special = torch.cat(special)
    xs, ys = torch.meshgrid(special, special, indexing="ij")
    g = torch.Generator().manual_seed(seed)
    rand = torch.rand((n, 2), generator=g) * 2.6 - 1.3
    return torch.cat([torch.stack([xs.reshape(-1), ys.reshape(-1)], -1), rand])[None].to(dev)


def phase_taps(dev):
    """The fused kernel's own tap computation (``quad_sample_taps``)
    against ``quad_indices`` bit for bit, in bf16 and f32: at the flagship
    grid read in place (both maps), at ragged coordinates (two frames,
    beyond the maps), and at coordinates on, beside and just beyond every
    edge."""
    grid = flagship_grid(dev)
    g = torch.Generator().manual_seed(12)
    ragged = (torch.rand((2, 37, 3, 3), generator=g) * 2.6 - 1.3).to(dev)[..., 0:2]
    cases = [("flagship", shape, grid[..., 0:2]) for shape in FLAGSHIP_SHAPES.values()]
    cases += [("ragged", (2, 11, 17, 8), ragged), ("ragged", (2, 3, 4, 8), ragged)]
    cases += [("edges", shape, edge_coords(dev, shape[1:3])) for shape in
              ((1, 5, 7, 8), (1, 1, 1, 8), FLAGSHIP_SHAPES["B"])]
    rows = []
    for name, shape, uv in cases:
        for dtype in (torch.bfloat16, torch.float32):
            f = torch.empty((shape[0], shape[1], shape[2], 1), dtype=dtype, device=dev)
            idx, w4 = quad_sample.quad_sample_taps(f, uv)
            torch.cuda.synchronize()
            ref_idx, ref_w4 = quad_sample.quad_indices(f, uv)
            row = {"case": name, "dtype": str(dtype).replace("torch.", ""),
                   "map": list(shape[:3]), "queries": int(idx.numel()),
                   "idx_equal": bool(torch.equal(idx, ref_idx)),
                   "w4_equal": bool(torch.equal(w4, ref_w4)),
                   "w4_max_abs_diff": float((w4 - ref_w4).abs().max()),
                   "taps_outside": int((w4 == 0).sum())}
            print("  " + json.dumps(row))
            rows.append(row)
            if not (row["idx_equal"] and row["w4_equal"]):
                raise AssertionError(f"taps {name} {row['dtype']} {shape}: not bit-equal")
    return rows


def scatter_inputs(p: int, c: int, n: int, gen, integer: bool, window: int = 2048):
    """P5's inputs on the card: ``n`` update indices, each tile of ``window``
    within a window of ``window`` table rows (``_bench_scatter_pallas.py::
    make_inputs``' generator, drawn here by the card's generator), and bf16
    rows, random or small integers."""
    dev = gen.device
    win = min(window, p)
    tiles = -(-n // window)
    base = torch.randint(0, p - win + 1, (tiles, 1), generator=gen, device=dev)
    idx = (base + torch.randint(0, win, (tiles, window), generator=gen, device=dev))
    idx = idx.reshape(-1)[:n].to(torch.int32)
    if integer:
        rows = torch.randint(-2, 3, (n, c), generator=gen, device=dev).to(torch.bfloat16)
    else:
        rows = torch.randn((n, c), generator=gen, device=dev, dtype=torch.bfloat16)
    return idx, rows


def scatter_case(name, idx, rows, p: int, timed: bool, exact: bool):
    """``row_scatter_add`` vs ``row_scatter_add_plain`` on one input.

    ``exact``: integer-valued rows, whose f32 sums are exact in any order,
    compared bit for bit. Otherwise both sum in f32 in another order and
    round once to the rows' dtype, so a result may sit one rounding apart:
    |kernel - plain| <= 1e-6 + 2 u |plain| (one unit in the last place of
    the dtype, whose unit round-off is u: 2^-7 |plain| in bf16) + k u_f32 S
    (the f32 order bound: k the most updates one row receives, S the row's
    sum of |rows|). Every case checks two calls
    bit for bit; ``timed`` also times the kernel with its binning (``ms``),
    the binning and the kernel alone, the plain version and ``index_add_``
    into a zeroed bf16 table, beside the bound."""
    dev = rows.device
    got = row_scatter.row_scatter_add(idx, rows, p)
    again = row_scatter.row_scatter_add(idx, rows, p)
    torch.cuda.synchronize()
    ref = row_scatter.row_scatter_add_plain(idx, rows, p)
    bins = row_scatter.row_scatter_bins(idx, p)
    counts = bins[1].diff()
    diff = (got.float() - ref.float()).abs()
    if exact:
        tol = torch.zeros_like(diff)
    else:
        s_abs = row_scatter.row_scatter_add_plain(idx, rows.float().abs(), p)
        u = {torch.bfloat16: 2.0 ** -8, torch.float32: F32_U}[rows.dtype]
        tol = 1e-6 + 2 * u * ref.float().abs() + int(counts.max()) * F32_U * s_abs
        del s_abs
    n, c = rows.shape
    row = {"case": name, "dtype": str(rows.dtype).replace("torch.", ""), "table": [p, c],
           "rows": n, "in_table": int(bins[1][-1]), "max_updates_per_row": int(counts.max()),
           "mean_updates_per_row": float(counts.float().mean()), "exact": exact,
           "max_abs_err": float(diff.max()),
           "max_err_over_tol": float((diff / tol.clamp(min=1e-30)).max()) if not exact else 0.0,
           "bit_equal_rerun": bool(torch.equal(got, again))}
    ok = bool((diff <= tol).all()) and row["bit_equal_rerun"]
    del diff, tol, ref, again
    if timed:
        isz = rows.element_size()
        # every update row and index read once, every table row written once
        nbytes = n * c * isz + n * idx.element_size() + p * c * isz
        ops = float(n * c)  # one f32 add per update element
        row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS_PER_S \
            else "operations"
        row["bytes"] = nbytes
        row["ms"] = cuda_ms(lambda: row_scatter.row_scatter_add(idx, rows, p))
        row["binning_ms"] = cuda_ms(lambda: row_scatter.row_scatter_bins(idx, p))
        row["kernel_only_ms"] = cuda_ms(lambda: row_scatter.row_scatter_add_kernel(rows, bins, p))
        row["plain_ms"] = cuda_ms(lambda: row_scatter.row_scatter_add_plain(idx, rows, p),
                                  iters=3, warmup=1)
        row["library"] = "index_add_ into a zeroed bf16 table"
        row["library_ms"] = cuda_ms(lambda: torch.zeros((p, c), dtype=rows.dtype,
                                                        device=dev).index_add_(0, idx, rows))
    print("  " + json.dumps(row))
    if not ok:
        raise AssertionError(f"{name}: max error {row['max_abs_err']} over its tolerance or "
                             f"two calls differ")
    return row


def phase_kernel_vs_plain_scatter(dev):
    """``row_scatter_add`` against its plain version at P5's four cases
    (3,174,400 rows into each table of ``_bench_scatter_pallas.py``'s
    CASES), random bf16 rows (timed) and integer-valued ones; then a ragged
    case: odd channels, negative and out-of-range indices, and one row
    receiving every update."""
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = []
    for name, p, cq in bench_scatter.CASES:
        for integer in (False, True):
            idx, upd = scatter_inputs(p, cq, FLAGSHIP_QUERIES, gen, integer)
            rows.append(scatter_case(name, idx, upd, p, timed=not integer, exact=integer))
            del idx, upd
            torch.cuda.empty_cache()
    p, n = 301, 40_000
    idx = torch.randint(-p - 50, p + 50, (n,), generator=gen, device=dev).to(torch.int32)
    idx[: n // 2] = 7  # one row receives half the updates, and another all of them below
    for integer in (False, True):
        upd = (torch.randint(-2, 3, (n, 37), generator=gen, device=dev).to(torch.bfloat16)
               if integer else torch.randn((n, 37), generator=gen, device=dev,
                                           dtype=torch.bfloat16))
        rows.append(scatter_case("ragged", idx, upd, p, timed=False, exact=integer))
        rows.append(scatter_case("one_row", torch.full_like(idx, -3), upd.float(), p,
                                 timed=False, exact=integer))
    return rows


# the case of P5's entry point that chip_smoke runs (numpy draws its inputs:
# about 25 s for each of the four at N = 3,174,400); kernel_vs_plain_scatter
# holds the kernel at all four
BENCH_SCATTER_CASES = ("g4",)


def phase_bench_scatter(dev):
    """P5's entry point, ``python -m hgsfusion_tpu_torch.bench_scatter``, on
    BENCH_SCATTER_CASES at 3 timed calls each: the kernel launched."""
    zero_launches()
    results = bench_scatter.main(["--cases", *BENCH_SCATTER_CASES, "--iters", "3",
                                  "--device", str(dev)])
    launches = dict(row_scatter.launches)
    # per case: the kernel, the kernel alone on prebuilt bins and the
    # outer-product route, each a warm-up and 3 calls
    want = {row_scatter.KERNEL: 3 * 4 * len(BENCH_SCATTER_CASES)}
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    return {"launches": launches, "cases": results}


def phase_kernel_vs_plain_reduce(dev):
    """The fused kernel at the flagship gather groups (both maps, the
    flagship frame's grid read in place as the module reads it, the reduce
    kernel's (256, 128) shape, a random bias) in bf16 (timed) and f32, and a
    ragged case."""
    uv = flagship_grid(dev)[..., 0:2]
    g = torch.Generator(device="cpu").manual_seed(4)
    maps = [torch.randn(shape, generator=g).to(dev) for shape in FLAGSHIP_SHAPES.values()]
    rows = [reduce_case("flagship", maps, uv, REDUCE_O, torch.bfloat16, g, timed=True),
            reduce_case("flagship", maps, uv, REDUCE_O, torch.float32, g, timed=False)]
    del maps
    torch.cuda.empty_cache()
    # odd channels and outputs, three groups of two frames, 222 queries
    maps = [torch.randn(shape, generator=g).to(dev)
            for shape in ((2, 11, 17, 13), (2, 6, 9, 37), (2, 3, 4, 5))]
    coords = (torch.rand((2, 37, 3, 3), generator=g) * 2.6 - 1.3).to(dev)[..., 0:2]
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(reduce_case("ragged", maps, coords, 45, dtype, g, timed=False))
    return {"rows": rows}


def polar_coords(dev):
    """The flagship frame's polar sample coordinates, by map of
    POLAR_SHAPES: the near-field grid (1, 320, 20, 31, 2) for both reduced
    maps, pass 3's clamped coordinates (1, 320, 300, 2) for q."""
    cfg = vod_polar_config()
    batch = flagship_batch(cfg)
    l2c, c2i, bda = (torch.from_numpy(batch[k]).to(dev) for k in
                     ("trans_lidar_to_cam", "trans_cam_to_img", "lidar_aug_matrix"))
    geo = polar_geometry(l2c, c2i, cfg.image_size, bda, grid_size=cfg.grid_size,
                         pc_range=cfg.pc_range, w_fine=POLAR_SHAPES["near_A"][2],
                         zeta_bins=cfg.f2v_polar_zeta_bins,
                         near_columns=cfg.f2v_polar_near_columns, bev_aug=cfg.bev_aug)
    # as the module reads them: near_uv is (u, v) of the near grid in place
    return {"near_A": geo.near_uv, "near_B": geo.near_uv, "q": geo.far_coords}


def phase_kernel_vs_plain_polar(dev):
    """Both kernels against their plain versions at the polar view's maps."""
    coords = polar_coords(dev)
    g = torch.Generator(device="cpu").manual_seed(3)
    rows = {"fwd": [], "bwd": []}
    for name, shape in POLAR_SHAPES.items():
        feats = torch.randn(shape, generator=g).to(dev)
        rows["fwd"].append(sampler_case(name, feats, coords[name], torch.bfloat16, BF16_TOL,
                                        timed=True))
        rows["fwd"].append(sampler_case(name, feats, coords[name], torch.float32, F32_TOL,
                                        timed=True))
        rows["bwd"].append(bwd_case(name, shape, coords[name], torch.bfloat16, g, timed=True))
        rows["bwd"].append(bwd_case(name, shape, coords[name], torch.float32, g, timed=False))
    return rows


def phase_polar_vs_gather(dev):
    """Full width, f32, one set of weights: the polar image BEV's near
    columns against the gather path's; the far field's agreement printed."""
    f32 = dict(compute_dtype="float32")
    gather = HGSFusionModel(dataclasses.replace(vod_pallas_config(), **f32), device=dev, seed=0)
    cfg = dataclasses.replace(vod_polar_config(), **f32)
    polar = HGSFusionModel(cfg, device=dev, seed=0)
    polar.load_state_dict(gather.state_dict(), strict=True)
    with torch.inference_mode():
        b = gather.batch_to_device(flagship_batch(cfg))
        feats = gather.image_features(b)
        ref = gather.view_transform(feats, b).double()
        got = polar.view_transform(feats, b).double()
    n = cfg.f2v_polar_near_columns
    scale = float(ref.abs().max())
    near_err = float((got[:, :, :n] - ref[:, :, :n]).abs().max())
    far_g, far_p = ref[:, :, n:].flatten(), got[:, :, n:].flatten()
    result = {
        "shape": list(got.shape), "max_abs_gather": scale,
        "near_columns": n, "near_max_abs_err": near_err,
        "near_err_over_max": near_err / scale, "near_tol": NEAR_TOL,
        "far_corr": float(torch.corrcoef(torch.stack([far_g, far_p]))[0, 1]),
        "far_rel_l2": float((far_p - far_g).norm() / far_g.norm()),
        "finite": bool(torch.isfinite(got).all()),
    }
    print("  " + json.dumps(result))
    if not result["finite"]:
        raise AssertionError("non-finite polar image BEV")
    if not near_err <= NEAR_TOL * scale:
        raise AssertionError(f"near field off the gather path: {near_err} > {NEAR_TOL} x {scale}")
    return result


def phase_small_reference(dev, cfg=TINY, batch=None):
    """TINY model: card (kernel path) vs CPU (plain sampler), same weights,
    on ``batch`` (default ``tiny_batch()``)."""
    cpu_model = HGSFusionModel(cfg, device="cpu", seed=5)
    gpu_model = HGSFusionModel(cfg, device=dev, seed=5)
    batch = tiny_batch() if batch is None else batch
    with torch.inference_mode():
        ref = cpu_model(cpu_model.batch_to_device(batch))
        got = gpu_model(gpu_model.batch_to_device(batch))
        errs = {k: float((got[k].cpu() - ref[k]).abs().max()) for k in ref}
        print("  head max abs err vs CPU: " + json.dumps(errs))
        for k in ref:
            torch.testing.assert_close(got[k].cpu(), ref[k], rtol=1e-4, atol=1e-4)
        # identical feature regions give exactly equal scores, which topk
        # orders differently on the two devices: break the ties first
        cls = ref["cls_preds"]
        ref = {**ref, "cls_preds": cls + torch.linspace(0, 0.1, cls.numel()).view(cls.shape)}
        kw = dict(score_thresh=0.0, nms_thresh=0.01, pre_max_size=512, post_max_size=100)
        d_ref = post_process(ref, cpu_model.anchors, cpu_model.box_coder, cfg, **kw)
        d_got = post_process({k: v.to(dev) for k, v in ref.items()}, gpu_model.anchors,
                             gpu_model.box_coder, cfg, **kw)
        assert torch.equal(d_got["valid"].cpu(), d_ref["valid"])
        v = d_ref["valid"]
        torch.testing.assert_close(d_got["boxes"].cpu()[v], d_ref["boxes"][v],
                                   rtol=1e-5, atol=1e-5)
        print(f"  post-process: {int(v.sum())} boxes kept on both")
    return errs


def run_train_step(cfg, device, batch, seed: int, perturb_seed=None):
    """One training step of a model built from ``seed`` (its backbone's
    residual scales at 0) on ``device``: ``step_compare.step_record`` and
    the step's learning rate. With ``perturb_seed``, the images and points
    are first perturbed by ``step_compare.PERTURB`` relative."""
    model = zero_residual_scales(HGSFusionModel(cfg, device=device, seed=seed))
    assigner = TargetAssigner(cfg.anchor_generator, cfg.grid_size, cfg.pc_range,
                              cfg.class_names, device=model.device)
    opt, lr_schedule = build_optimizer(cfg.optimization, TRAIN_TOTAL_STEPS, model)
    cap = GradCapture(opt)
    step = make_train_step(model, assigner, cap, cfg.loss_weights, cfg)
    b = model.batch_to_device(batch)
    if perturb_seed is not None:
        b = perturb_inputs(b, perturb_seed)
    _, tb = step(b)
    return step_record(model, cap, tb), float(lr_schedule(0))


def phase_small_reference_train(dev, cfg=TINY, batch=None):
    """TINY training step: card (kernels) vs CPU (plain versions), on
    ``batch`` (default ``tiny_batch()``)."""
    batch = tiny_batch() if batch is None else batch
    ref, lr = run_train_step(cfg, "cpu", batch, seed=TRAIN_REF_SEED)
    probes = [run_train_step(cfg, "cpu", batch, seed=TRAIN_REF_SEED, perturb_seed=s)[0]["grads"]
              for s in (1, 2)]
    got, _ = run_train_step(cfg, dev, batch, seed=TRAIN_REF_SEED)
    report = compare_steps(ref, got, sensitivity(ref["grads"], probes), lr)
    report["loss_terms_cpu"] = {k: float(v) for k, v in ref["tb"].items()}
    report["loss_terms_card"] = {k: float(v) for k, v in got["tb"].items()}
    print("  " + json.dumps(report))
    return report


def phase_small_reference_polar(dev):
    """The TINY polar model, card vs CPU: serving, then one training step."""
    return {"serve": phase_small_reference(dev, TINY_POLAR),
            "train": phase_small_reference_train(dev, TINY_POLAR)}


def phase_small_reference_xla(dev):
    """The TINY model under ``SAMPLER_KERNEL: xla``, card vs CPU: serving,
    then one training step, with the card's launches counted."""
    zero_launches()
    out = {"serve": phase_small_reference(dev, TINY_XLA),
           "train": phase_small_reference_train(dev, TINY_XLA)}
    out["launches"] = dict(quad_sample.launches)
    # the served frame: one fused launch; the step: 2 forward, 2 backward, 2 bins
    want = per_frames({quad_sample.KERNEL: 2, quad_sample.REDUCE_KERNEL: 1,
                       quad_sample.BWD_KERNEL: 2, quad_sample.BINS: 2}, 1)
    print(f"  launches on the card: {out['launches']}")
    if out["launches"] != want:
        raise AssertionError(f"launches {out['launches']}, want {want}")
    return out


def phase_train(dev, cfg, per_step: int):
    """3 full-width training steps of ``cfg`` after a warm-up, each launching
    ``per_step`` forward and backward kernels and building as many bins."""
    model = HGSFusionModel(cfg, device=dev, seed=0)
    batch = model.batch_to_device(flagship_batch(cfg))
    assigner = TargetAssigner(cfg.anchor_generator, cfg.grid_size, cfg.pc_range,
                              cfg.class_names, device=dev)
    positives = int((assigner(batch["gt_boxes"])["box_cls_labels"] > 0).sum())
    if positives == 0:
        raise AssertionError("no anchor is positive for the synthetic gt boxes")
    opt, _ = build_optimizer(cfg.optimization, TRAIN_TOTAL_STEPS, model)
    cap = GradCapture(opt)
    step = make_train_step(model, assigner, cap, cfg.loss_weights, cfg)
    params = dict(model.named_parameters())
    trainable = [k for k, p in params.items() if p.requires_grad]
    frozen = {k: p.detach().clone() for k, p in params.items() if k.startswith(FROZEN_PREFIX)}
    before = {k: p.detach().clone() for k, p in params.items() if p.requires_grad}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith(FROZEN_PREFIX) and k.endswith(("running_mean", "running_var"))}

    step(batch)  # warm-up: cuDNN plans, allocator
    moving = {k for k, g in zip(trainable, cap.grads)
              if bool(before[k].any()) or (g is not None and bool(g.any()))}
    cap.grads = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    # the main path: 3 training steps
    zero_launches()
    wall, terms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        _, tb = step(batch)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        terms.append({k: float(v) for k, v in tb.items()})
    launches = dict(quad_sample.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    want = per_frames({quad_sample.KERNEL: per_step, quad_sample.BWD_KERNEL: per_step,
                       quad_sample.BINS: per_step}, 3)
    if launches != want:
        raise AssertionError(f"launches in 3 steps {launches}, want {want}")
    for t in terms:
        if not all(math.isfinite(v) for v in t.values()):
            raise AssertionError(f"non-finite loss terms {t}")
    params = dict(model.named_parameters())
    for k, v in frozen.items():
        if not torch.equal(params[k], v):
            raise AssertionError(f"frozen backbone parameter {k} changed")
    still = sorted(k for k in moving if torch.equal(params[k], before[k]))
    if still:
        raise AssertionError(f"trainable tensors that did not move: {still}")
    state = model.state_dict()
    same = sorted(k for k, v in stats.items() if torch.equal(state[k], v))
    if same:
        raise AssertionError(f"backbone BN statistics that did not move: {same}")

    # one more step with CUDA's sync debugging on: the step never makes the
    # host wait for the device
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    if syncs:
        raise AssertionError("the training step made the host wait for the device at "
                             f"{sorted(set(syncs))}")
    # one more step under the profiler: device time by kernel
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    ops = sorted(((e.key, getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0.0)) / 1e3, e.count)
                  for e in prof.key_averages()), key=lambda r: -r[1])
    result = {
        "steps": 3, "launches": launches, "step_s": wall, "steps_per_s": 3 / sum(wall),
        "peak_memory_bytes": peak, "positive_anchors": positives, "loss_terms": terms,
        "trainable_tensors": len(before), "moved": len(moving), "frozen_tensors": len(frozen),
        "profiled_step_device_ms": sum(ms for _, ms, _ in ops),
        "profiled_step_top": [{"op": k[:90], "device_ms": ms, "calls": n}
                              for k, ms, n in ops[:15]],
    }
    print("  " + json.dumps(result))
    return result


# the paths whose launches the kernels line counts, each taken with the
# counters at 0 just before it
MAIN_PATHS = ("serve", "train", "serve_polar", "train_polar", "eval", "eval_polar", "train_cli",
              "bench_scatter", "serve_tj4d", "serve_tj4d_polar", "train_cli_tj4d",
              "eval_tj4d_polar", "rhgm")


def per_frames(per_frame: dict, frames: int) -> dict:
    """Every counter of ``quad_sample.launches`` after ``frames`` frames that
    each launch ``per_frame`` (the counters it does not name: 0)."""
    return {k: frames * per_frame.get(k, 0) for k in quad_sample.launches}


# launches per served or evaluated frame: the gather view's two groups in
# one fused launch, the polar view's three samples
GATHER_FRAME = {quad_sample.REDUCE_KERNEL: 1}
POLAR_FRAME = {quad_sample.KERNEL: 3}


def phase_serve(dev, cfg, per_frame: dict, batch=None):
    """3 full-width frames of ``cfg`` through ``serve()`` after a warm-up,
    each launching the kernels ``per_frame`` counts, then one staged frame;
    ``batch`` defaults to ``flagship_batch(cfg)``."""
    t0 = time.perf_counter()
    model = HGSFusionModel(cfg, device=dev, seed=0)
    build_s = time.perf_counter() - t0
    batch = flagship_batch(cfg) if batch is None else batch
    stages = ("backbone", "view_transform", "radar_branch", "fusion_head", "post_process")

    model.serve(batch)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    # the main path: 3 frames through the serving entry point
    zero_launches()
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        dets = model.serve(batch)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    launches = dict(quad_sample.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    want = per_frames(per_frame, 3)
    if launches != want:
        raise AssertionError(f"launches in 3 frames {launches}, want {want}")
    n_valid = int(dets["valid"].sum())
    assert dets["boxes"].shape == (1, cfg.nms_post_max_size, 7), dets["boxes"].shape
    assert 0 <= n_valid <= cfg.nms_post_max_size
    assert bool(torch.isfinite(dets["boxes"][dets["valid"]]).all())

    # one more frame through the serve stages, with CUDA events between them
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
    with torch.inference_mode():
        b = model.batch_to_device(batch)
        ev[0].record()
        feats = model.image_features(b)
        ev[1].record()
        image_bev = model.view_transform(feats, b)
        ev[2].record()
        radar_bev = model.radar_branch(b)
        ev[3].record()
        preds = model.fusion_and_head(image_bev, radar_bev)
        ev[4].record()
        staged = model.post_process(preds)
        ev[5].record()
    ev[5].synchronize()
    for k, v in preds.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite head output {k}")
    if not torch.equal(staged["valid"], dets["valid"]):
        raise AssertionError("the staged frame kept other boxes than serve()")
    # the post-process's worst case: every anchor passes the score threshold,
    # so 4096 candidates enter the NMS and up to 500 are kept
    with torch.inference_mode():
        worst_ms = cuda_ms(lambda: post_process(
            preds, model.anchors, model.box_coder, cfg, 0.0, cfg.nms_thresh,
            cfg.nms_pre_max_size, cfg.nms_post_max_size), iters=3, warmup=1)
        worst = post_process(preds, model.anchors, model.box_coder, cfg, 0.0,
                             cfg.nms_thresh, cfg.nms_pre_max_size, cfg.nms_post_max_size)
    result = {
        "frames": 3, "launches": launches,
        "frame_s": wall, "frames_per_s": 3 / sum(wall),
        "stage_ms": {s: ev[i].elapsed_time(ev[i + 1]) for i, s in enumerate(stages)},
        "peak_memory_bytes": peak, "valid_boxes": n_valid,
        "post_process_all_candidates_ms": worst_ms,
        "post_process_all_candidates_kept": int(worst["valid"].sum()),
        "model_build_s": build_s,
        "head_shapes": {k: list(v.shape) for k, v in preds.items()},
    }
    print("  " + json.dumps(result))
    return result


EVAL_FRAMES = 16
TINY_EVAL_FRAMES = 4
EVAL_BOX_TOL, EVAL_RESULT_TOL = 1e-4, 1e-6


def tiny_eval_config(root) -> dict:
    """``configs/hgsfusion_vod.yaml``'s data and post-processing blocks
    (``vod_dataset_config``) cut to TINY's range, voxels, image and point
    budget, over the tree at ``root``."""
    cfg = vod_dataset_config(root)
    data = cfg["DATA_CONFIG"]
    data.update(POINT_CLOUD_RANGE=list(TINY.pc_range), IMAGE_SIZE=list(TINY.image_size),
                MAX_POINTS=1024, MAX_GT_BOXES=16, VIRTUAL_POINT_PREFIX="virtual_points")
    data["DATA_PROCESSOR"][1]["VOXEL_SIZE"] = list(TINY.voxel_size)
    return cfg


def tie_free_threshold(scores, min_gap: float, per_frame: int) -> float:
    """A score threshold about ``per_frame`` candidates of each frame pass,
    such that no two passing scores of a frame, and no score and the
    threshold, are within ``min_gap``: exact ties would be ordered
    differently by the two devices' top-k."""
    pooled = np.sort(np.concatenate(scores))[::-1]
    k = per_frame * len(scores)
    thr = float(pooled[k - 1] + pooled[k]) / 2
    for s in scores:
        kept = np.sort(s[s >= thr])
        if kept.size == 0:
            raise AssertionError("a frame has no candidate above the threshold")
        if kept.size > 1 and np.diff(kept).min() <= min_gap:
            raise AssertionError(f"two passing scores within {min_gap}")
        if np.abs(s - thr).min() <= min_gap:
            raise AssertionError(f"a score within {min_gap} of the threshold")
    return thr


def phase_small_reference_eval(dev):
    """The TINY model through ``run_eval``: card (kernel) vs CPU (plain
    sampler), same weights and frames."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        make_synthetic_kitti(root, num_frames=TINY_EVAL_FRAMES, num_points=256,
                             num_virtual=64, image_hw=TINY.image_size, structured=True)
        cfg = tiny_eval_config(root)
        create_infos(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"])
        return compare_run_eval(dev, cfg, TINY, per_frame=8)


def compare_run_eval(dev, cfg, model_cfg, per_frame: int):
    """``run_eval`` of the ``model_cfg`` model (weights seed 5) over the
    dataset of ``cfg`` (its tree and infos written): card (kernel) vs CPU
    (plain sampler), at a tie-free score threshold of about ``per_frame``
    candidates a frame."""
    logger = create_logger()
    models = {"cpu": HGSFusionModel(model_cfg, device="cpu", seed=5),
              "card": HGSFusionModel(model_cfg, device=dev, seed=5)}
    ds = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False, logger=logger)
    scores = {}
    with torch.inference_mode():
        for name, m in models.items():
            scores[name] = [torch.sigmoid(m(m.batch_to_device(ds.collate_batch([ds[i]])))[
                "cls_preds"].float().reshape(-1, model_cfg.num_class)).max(-1).values.cpu().numpy()
                for i in range(len(ds))]
    score_diff = max(float(np.abs(a - b).max()) for a, b in zip(scores["cpu"], scores["card"]))
    min_gap = 10 * score_diff
    thr = tie_free_threshold(scores["cpu"], min_gap, per_frame=per_frame)
    out = {}
    for name, m in models.items():
        m.cfg = dataclasses.replace(model_cfg, score_thresh=thr, nms_pre_max_size=512,
                                    nms_post_max_size=100)
        ds = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False,
                           logger=logger)
        out[name] = run_eval(cfg, m, ds, logger)
    (ref, ref_res, _), (got, got_res, stats) = out["cpu"], out["card"]
    if [a["frame_id"] for a in got] != [a["frame_id"] for a in ref]:
        raise AssertionError("the card's frames differ from the CPU's")
    box_err = 0.0
    for g, r in zip(got, ref):
        if list(g["name"]) != list(r["name"]):
            raise AssertionError(f"frame {g['frame_id']}: other boxes kept on the card")
        if len(r["name"]):
            box_err = max(box_err, float(np.abs(g["boxes_lidar"] - r["boxes_lidar"]).max()))
    res_err = max(abs(got_res[k] - ref_res[k]) for k in ref_res)
    result = {"frames": len(got), "boxes": sum(len(a["name"]) for a in got),
              "score_thresh": thr, "score_max_abs_err": score_diff, "min_gap": min_gap,
              "box_max_abs_err": box_err, "result_max_abs_err": res_err,
              "launches_per_batch": stats["launches_per_batch"]}
    print("  " + json.dumps(result))
    if result["boxes"] == 0:
        raise AssertionError("no box passed the threshold")
    if not box_err <= EVAL_BOX_TOL or not res_err <= EVAL_RESULT_TOL:
        raise AssertionError(f"card vs CPU: boxes {box_err}, result dict {res_err}")
    return result


def annos_equal(a, b) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) else a[k] == b[k] for k in a)


def write_tree(root, data, frames: int):
    """A structured synthetic tree of ``frames`` full-width frames (2048
    radar and 4096 virtual points, ``data``'s image size and virtual-point
    prefix) in the format of ``data``'s dataset, VoD or TJ4D."""
    kw = dict(num_frames=frames, num_points=2048, num_virtual=4096,
              image_hw=tuple(data["IMAGE_SIZE"]), virtual_prefix=data["VIRTUAL_POINT_PREFIX"])
    if data["DATASET"] == "TJ4DDataset":
        return make_synthetic_tj4d(root, **kw)
    return make_synthetic_kitti(root, structured=True, **kw)


# each dataset's headline number in the result dict
HEADLINE = {"VODDataset": "entire_area/mAP_3d", "TJ4DDataset": "KITTI/Overall_3D_moderate"}


def phase_eval(dev, yaml_path, per_frame: dict, preset=None):
    """``run_eval`` over a 16-frame synthetic tree of the config's dataset at
    full width, then the same frames through ``serve`` one by one; the
    config must equal ``preset`` where one is given."""
    cfg = load_config(yaml_path)
    model_cfg = model_config_from_yaml(cfg)
    if preset is not None and model_cfg != preset:
        raise AssertionError(f"{yaml_path} differs from its preset")
    data = cfg["DATA_CONFIG"]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        data["DATA_PATH"] = str(root)
        t0 = time.perf_counter()
        write_tree(root, data, EVAL_FRAMES)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        create_infos(data, cfg["CLASS_NAMES"])
        infos_s = time.perf_counter() - t0
        logger = create_logger()
        ds = build_dataset(data, cfg["CLASS_NAMES"], training=False, logger=logger)
        model = HGSFusionModel(model_cfg, device=dev, seed=0)
        # random weights score every anchor near 0.0125, under the config's
        # SCORE_THRESH of 0.1, and would keep no box: the threshold goes to
        # the middle of the first frame's 12th and 13th best scores, so the
        # NMS, the annotations, the recall and the AP have boxes to work on
        with torch.inference_mode():
            preds = model(model.batch_to_device(ds.collate_batch([ds[0]])))
        scores = torch.sigmoid(preds["cls_preds"].float().reshape(-1, model_cfg.num_class))
        top = torch.topk(scores.max(-1).values, 13).values.cpu().numpy()
        thr = float(top[11] + top[12]) / 2
        model.cfg = dataclasses.replace(model_cfg, score_thresh=thr)
        model.serve(ds.collate_batch([ds[0]]))  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        # the main path: the evaluation loop over every frame
        zero_launches()
        t0 = time.perf_counter()
        annos, result_dict, stats = run_eval(cfg, model, ds, logger, batch_size=1,
                                             infer_time=True)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(quad_sample.launches)
        peak = torch.cuda.max_memory_allocated(dev)
        want = per_frames(per_frame, EVAL_FRAMES)
        if launches != want:
            raise AssertionError(f"launches in {EVAL_FRAMES} frames {launches}, want {want}")
        per_batch = per_frames(per_frame, 1)
        if any(b != per_batch for b in stats["launches_per_batch"]):
            raise AssertionError(f"launches per frame {stats['launches_per_batch']}")

        # the same frames through serve, one by one: the same annotations,
        # and serve's own time on a batch already on the card
        serve_ms = []
        for i in range(len(ds)):
            batch = ds.collate_batch([ds[i]])
            on_card = model.batch_to_device(batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = model.serve(on_card)
            torch.cuda.synchronize()
            serve_ms.append((time.perf_counter() - t1) * 1e3)
            ref = ds.generate_prediction_dicts(batch, detections_to_pred_dicts(out),
                                               ds.class_names)[0]
            if not annos_equal(annos[i], ref):
                raise AssertionError(f"frame {i}: run_eval's annotations differ from serve's")
        points = int(ds[0]["points_valid"].sum())
    if not any(len(a["name"]) for a in annos):
        raise AssertionError("no frame kept a box")
    values = list(result_dict.values())
    if not all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in values):
        raise AssertionError(f"an AP outside [0, 100]: {result_dict}")
    if not all(0 <= c <= stats["total_gt"] for c in stats["recall"].values()):
        raise AssertionError(f"recall counts {stats['recall']} of {stats['total_gt']}")
    steady = serve_ms[2:]
    result = {
        "frames": len(annos), "launches": launches,
        "points_per_frame": points,
        "score_thresh": thr, "boxes": sum(len(a["name"]) for a in annos),
        "pipelined_ms_per_frame": stats["ms_per_frame"],
        "pipelined_frames_per_s": 1e3 / stats["ms_per_frame"],
        "serve_ms_per_frame": float(np.mean(steady)),
        "serve_frames_per_s": 1e3 / float(np.mean(steady)),
        "host_ms_per_frame": stats["host_ms_per_frame"],
        "h2d_device_ms_per_frame": stats["h2d_device_ms_per_frame"],
        "eval_s": stats["eval_s"], "run_eval_wall_s": wall_s,
        "tree_write_s": write_s, "create_infos_s": infos_s,
        "recall": {str(k): v for k, v in stats["recall"].items()}, "total_gt": stats["total_gt"],
        "peak_memory_bytes": peak, "headline": HEADLINE[data["DATASET"]],
        "headline_value": result_dict[HEADLINE[data["DATASET"]]],
    }
    print("  " + json.dumps(result))
    return result


VOD_YAML = "configs/hgsfusion_vod.yaml"
TRAIN_CLI_FRAMES, TRAIN_CLI_STEPS, RESUME_STEPS, TRAIN_CLI_EVAL_FRAMES = 16, 20, 4, 8


def phase_train_cli(dev, yaml_path=VOD_YAML):
    """``tools/train.py`` and ``tools/test.py --ckpt_dir`` on the paper's
    own config at full width: train across an epoch boundary, resume,
    evaluate the newest checkpoint."""
    cfg = load_config(yaml_path)
    model_cfg = model_config_from_yaml(cfg)
    if model_cfg.f2v_sampler_kernel != "xla" or dataclasses.replace(
            model_cfg, f2v_sampler_kernel="pallas") != vod_pallas_config():
        raise AssertionError(f"{yaml_path} is not the pallas preset with SAMPLER_KERNEL: xla")
    data = cfg["DATA_CONFIG"]
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        root, out = Path(tmp) / "data", Path(tmp) / "out"
        data["DATA_PATH"] = str(root)
        t0 = time.perf_counter()
        write_tree(root, data, TRAIN_CLI_FRAMES)
        create_infos(data, cfg["CLASS_NAMES"])
        tree_s = time.perf_counter() - t0
        common = ["--cfg_file", yaml_path, "--fix_random_seed", "--epochs", "2", "--workers", "4",
                  "--output_dir", str(out)]
        data_set = ["--set", "DATA_CONFIG.DATA_PATH", str(root)]

        # the main path: the first training run
        zero_launches()
        first = train_cli.main(common + ["--max_steps", str(TRAIN_CLI_STEPS)] + data_set)
        first["launches"] = dict(quad_sample.launches)
        ckpt = CheckpointManager(Path(first["out_dir"]) / "ckpt")
        first_steps = ckpt.all_steps()

        # the resume: its restored state against the newest file
        run = train_cli.prepare(train_cli.parse_args(
            common + ["--max_steps", str(RESUME_STEPS), "--profile_steps",
                      f"{TRAIN_CLI_STEPS + 1}:{TRAIN_CLI_STEPS + 1}"] + data_set))
        saved = torch.load(ckpt.path(TRAIN_CLI_STEPS), map_location="cpu", weights_only=True)
        model_equal = all(torch.equal(v.cpu(), saved["model_state"][k])
                          for k, v in run.model.state_dict().items())
        opt = run.optimizer.state_dict()
        opt_equal = (torch.equal(opt["count"].cpu(), saved["optimizer_state"]["count"])
                     and all(torch.equal(a.cpu(), b) for key in ("mu", "nu")
                             for a, b in zip(opt[key], saved["optimizer_state"][key])))
        log = (Path(first["out_dir"]) / "train.log").read_text()
        zero_launches()
        second = train_cli.fit(run)
        second["launches"] = dict(quad_sample.launches)

        # the evaluation of the newest checkpoint
        zero_launches()
        t0 = time.perf_counter()
        evaluated = test_cli.main(["--cfg_file", yaml_path, "--ckpt_dir", str(ckpt.ckpt_dir),
                                   "--max_frames", str(TRAIN_CLI_EVAL_FRAMES), "--output_dir",
                                   str(out / "eval")] + data_set)
        eval_s = time.perf_counter() - t0
        eval_launches = dict(quad_sample.launches)
        final_steps = ckpt.all_steps()

    def check(ok, what):
        if not ok:
            failures.append(what)

    for name, r, steps in (("first", first, TRAIN_CLI_STEPS), ("resume", second, RESUME_STEPS)):
        want = per_frames({quad_sample.KERNEL: 2, quad_sample.BWD_KERNEL: 2,
                           quad_sample.BINS: 2}, steps)
        check(r["launches"] == want, f"{name}: launches {r['launches']}, want {want}")
        check(r["steps"] == steps and all(math.isfinite(v) for v in r["losses"]),
              f"{name}: {r['steps']} steps, losses {r['losses']}")
    check(first["augmentation"]["flipped"] > 0, "no flipped frame was fed")
    check(first["augmentation"]["aug_matrix"] > 0, "every lidar_aug_matrix was the identity")
    check(first_steps == [TRAIN_CLI_FRAMES, TRAIN_CLI_STEPS],
          f"checkpoints after the first run: {first_steps}")
    check(run.resumed_from == run.start_step == TRAIN_CLI_STEPS
          and f"auto-resumed from step {TRAIN_CLI_STEPS}" in log,
          f"resumed from {run.resumed_from} at step {run.start_step}")
    check(model_equal and opt_equal, f"restored state differs from the file: model "
          f"{model_equal}, optimizer {opt_equal}")
    check(second["end_step"] == TRAIN_CLI_STEPS + RESUME_STEPS, f"resume ended at "
          f"{second['end_step']}")
    check(second["profile_device_ms"] is not None and second["profile_device_ms"] > 0,
          f"profiled step device ms {second['profile_device_ms']}")
    check(final_steps == [TRAIN_CLI_FRAMES, TRAIN_CLI_STEPS, TRAIN_CLI_STEPS + RESUME_STEPS],
          f"checkpoints at the end: {final_steps}")
    eval_step = TRAIN_CLI_STEPS + RESUME_STEPS
    want = per_frames(GATHER_FRAME, TRAIN_CLI_EVAL_FRAMES)
    check(sorted(evaluated) == [eval_step], f"evaluated steps {sorted(evaluated)}")
    check(eval_launches == want, f"eval launches {eval_launches}, want {want}")
    result_dict, stats = evaluated.get(eval_step, ({}, {}))
    check(stats.get("frames") == TRAIN_CLI_EVAL_FRAMES
          and all(math.isfinite(v) and 0 <= v <= 100 for v in result_dict.values()),
          f"evaluation: {stats.get('frames')} frames, {result_dict}")

    waits = first["loader_wait_s"]
    result = {
        "config": yaml_path, "frames": TRAIN_CLI_FRAMES, "tree_and_infos_s": tree_s,
        "launches": {k: first["launches"][k] + second["launches"][k] + eval_launches[k]
                     for k in eval_launches},
        "launches_by_run": {"train": first["launches"], "resume": second["launches"],
                            "eval": eval_launches},
        "steps_per_s": first["steps_per_s"],
        "steps_per_s_excl_saves": first["steps_per_s_excl_saves"],
        "loader_wait_ms": {"mean": 1e3 * float(np.mean(waits[2:])),
                           "max": 1e3 * float(np.max(waits[2:])),
                           "first_two": [1e3 * w for w in waits[:2]]},
        "augmentation": first["augmentation"],
        "losses": first["losses"] + second["losses"],
        "profiled_step_device_ms": second["profile_device_ms"],
        "saves": first["saves"] + second["saves"], "resume_s": run.resume_s,
        "checkpoint_bytes": first["saves"][-1]["bytes"] if first["saves"] else None,
        "peak_memory_bytes": first["peak_memory_bytes"],
        "resume_steps_per_s": second["steps_per_s"],
        "checkpoints": final_steps, "restored_bit_equal": model_equal and opt_equal,
        "eval_s": eval_s, "eval_ms_per_frame": stats.get("ms_per_frame"),
        "eval_result": result_dict,
    }
    print("  " + json.dumps(result))
    if failures:
        raise AssertionError("; ".join(failures))
    return result


TJ4D_YAMLS = {"xla": "configs/hgsfusion_tj4d.yaml", "pallas": "configs/hgsfusion_tj4d_pallas.yaml",
              "polar": "configs/hgsfusion_tj4d_polar.yaml"}
# the TINY TJ4D model: 1 m voxels, nx 32, ny 40, nz 6, and a 50x80 image
TINY_TJ4D_RANGE = [0, -20, -4, 32, 20, 2]
TINY_TJ4D_FRAMES = 4
# the augmentation seed of the TINY TJ4D step's two frames: one whose step
# (weights TRAIN_REF_SEED) the CPU's own probes find well conditioned
# (step_compare.SENS_CAP: seed 1 at 2.8e-5 of the cap's 1e-3; seeds 3, 5
# and 6 over it)
TINY_TJ4D_TRAIN_SEED = 1
TJ4D_CLI_FRAMES, TJ4D_CLI_STEPS, TJ4D_CLI_EVAL_FRAMES = 16, 10, 8


def tiny_tj4d_cut(cfg, root):
    """A loaded ``hgsfusion_tj4d*.yaml`` cut to the TINY TJ4D model over the
    tree at ``root``: TINY_TJ4D_RANGE at 1 m, a 50x80 image, ResNet-50, 16
    depth bins to 32 m, f32; TJ4D's 4 classes, 8 anchors, 18 point
    features, ASPP dilation and BEV_AUG as they are."""
    data = cfg["DATA_CONFIG"]
    data.update(DATA_PATH=str(root), POINT_CLOUD_RANGE=list(TINY_TJ4D_RANGE),
                IMAGE_SIZE=[50, 80], MAX_POINTS=1024, MAX_GT_BOXES=16,
                VIRTUAL_POINT_PREFIX="virtual_points")
    data["DATA_PROCESSOR"][1]["VOXEL_SIZE"] = [1.0, 1.0, 1.0]
    model = cfg["MODEL"]
    model["COMPUTE_DTYPE"] = "float32"
    ffn = model["FusionVFE"]["ImageVFE"]["FFN"]
    ffn["DDN"]["BACKBONE_NAME"] = "ResNet50"
    ffn["DISCRETIZE"].update(num_bins=16, depth_max=32.0)
    model["FusionVFE"]["RadarBackbone"]["READER"]["PC_RANGE"] = list(TINY_TJ4D_RANGE)
    model["POST_PROCESSING"]["NMS_CONFIG"].update(NMS_PRE_MAXSIZE=512, NMS_POST_MAXSIZE=100)
    return cfg


def write_tiny_tj4d_tree(root):
    """TINY_TJ4D_FRAMES frames at 50x80 whose Car, Pedestrian, Cyclist and
    Truck (3 m to about 28 m) lie in TINY_TJ4D_RANGE."""
    return make_synthetic_tj4d(root, num_frames=TINY_TJ4D_FRAMES, num_points=256,
                               num_virtual=64, image_hw=(50, 80), num_boxes=4, box_x0=3.0,
                               box_spread=28.0)


def tj4d_config(view: str):
    """``configs/hgsfusion_tj4d{,_pallas,_polar}.yaml``'s model config."""
    return model_config_from_yaml(load_config(TJ4D_YAMLS[view]))


def tj4d_serve_batch(cfg):
    """``flagship_batch`` at TJ4D's image size, with the synthetic trees'
    intrinsics for that size (``make_calib``: the camera at the image's
    center)."""
    return flagship_batch(cfg, cam_to_img=make_calib(cfg.image_size)["P2"])


def phase_small_reference_tj4d(dev):
    """The TINY TJ4D model (``tiny_tj4d_cut`` of hgsfusion_tj4d_pallas.yaml),
    card vs CPU over a synthetic TJ4D tree: serving two frames (as
    ``phase_small_reference``), one training step at B=2 on two augmented
    frames with a Truck among their boxes (as ``phase_small_reference_train``;
    1 fused launch, then 2 forward, 2 backward and 2 bins on the card), then
    ``run_eval`` over the tree (as ``phase_small_reference_eval``)."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        write_tiny_tj4d_tree(root)
        cfg = tiny_tj4d_cut(load_config(TJ4D_YAMLS["pallas"]), root)
        create_infos(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"])
        model_cfg = model_config_from_yaml(cfg)
        if (model_cfg.grid_size, model_cfg.num_anchors_per_location) != ((32, 40, 6), 8):
            raise AssertionError(f"TINY TJ4D grid {model_cfg.grid_size}, "
                                 f"{model_cfg.num_anchors_per_location} anchors")
        ds = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False)
        train_ds = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=True)
        np.random.seed(TINY_TJ4D_TRAIN_SEED)
        train_batch = train_ds.collate_batch([train_ds[i] for i in range(2)])
        if not (train_batch["gt_boxes"][..., -1] == 4).any():
            raise AssertionError("no Truck among the training frames' boxes")
        zero_launches()
        out = {"serve": phase_small_reference(dev, model_cfg,
                                              ds.collate_batch([ds[i] for i in range(2)])),
               "train": phase_small_reference_train(dev, model_cfg, train_batch)}
        out["launches"] = dict(quad_sample.launches)
        want = per_frames({quad_sample.KERNEL: 2, quad_sample.REDUCE_KERNEL: 1,
                           quad_sample.BWD_KERNEL: 2, quad_sample.BINS: 2}, 1)
        print(f"  launches on the card: {out['launches']}")
        if out["launches"] != want:
            raise AssertionError(f"launches {out['launches']}, want {want}")
        out["eval"] = compare_run_eval(dev, cfg, model_cfg, per_frame=7)
    return out


def phase_train_cli_tj4d(dev):
    """``tools/train.py`` on ``configs/hgsfusion_tj4d.yaml`` (SAMPLER_KERNEL:
    xla, BATCH_SIZE_PER_DEVICE: 2) at full width over a 16-frame synthetic
    TJ4D tree, across an epoch boundary (8 steps), its second step profiled
    (before the window of ``steps_per_s``, which starts at the third); then
    ``tools/test.py --ckpt_dir`` over 8 frames."""
    yaml_path = TJ4D_YAMLS["xla"]
    cfg = load_config(yaml_path)
    model_cfg = model_config_from_yaml(cfg)
    batch = cfg["OPTIMIZATION"]["BATCH_SIZE_PER_DEVICE"]
    if model_cfg.f2v_sampler_kernel != "xla" or batch != 2:
        raise AssertionError(f"{yaml_path}: sampler {model_cfg.f2v_sampler_kernel}, B={batch}")
    data = cfg["DATA_CONFIG"]
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        root, out = Path(tmp) / "data", Path(tmp) / "out"
        data["DATA_PATH"] = str(root)
        t0 = time.perf_counter()
        write_tree(root, data, TJ4D_CLI_FRAMES)
        create_infos(data, cfg["CLASS_NAMES"])
        tree_s = time.perf_counter() - t0
        data_set = ["--set", "DATA_CONFIG.DATA_PATH", str(root)]
        # the main path: a training run
        zero_launches()
        run = train_cli.main(["--cfg_file", yaml_path, "--fix_random_seed", "--epochs", "2",
                              "--workers", "4", "--output_dir", str(out), "--max_steps",
                              str(TJ4D_CLI_STEPS), "--profile_steps", "1:1"]
                             + data_set)
        run["launches"] = dict(quad_sample.launches)
        ckpt = CheckpointManager(Path(run["out_dir"]) / "ckpt")
        steps = ckpt.all_steps()
        # the evaluation of the newest checkpoint
        zero_launches()
        t0 = time.perf_counter()
        evaluated = test_cli.main(["--cfg_file", yaml_path, "--ckpt_dir", str(ckpt.ckpt_dir),
                                   "--max_frames", str(TJ4D_CLI_EVAL_FRAMES), "--output_dir",
                                   str(out / "eval")] + data_set)
        eval_s = time.perf_counter() - t0
        eval_launches = dict(quad_sample.launches)

    def check(ok, what):
        if not ok:
            failures.append(what)

    want = per_frames({quad_sample.KERNEL: 2, quad_sample.BWD_KERNEL: 2, quad_sample.BINS: 2},
                      TJ4D_CLI_STEPS)
    check(run["launches"] == want, f"launches {run['launches']}, want {want}")
    check(run["steps"] == TJ4D_CLI_STEPS and all(math.isfinite(v) for v in run["losses"]),
          f"{run['steps']} steps, losses {run['losses']}")
    check(run["augmentation"]["frames"] == 2 * TJ4D_CLI_STEPS, f"frames fed "
          f"{run['augmentation']['frames']}")
    check(run["augmentation"]["flipped"] > 0, "no flipped frame was fed")
    check(run["augmentation"]["aug_matrix"] > 0, "every lidar_aug_matrix was the identity")
    epoch = TJ4D_CLI_FRAMES // batch
    check(steps == [epoch, TJ4D_CLI_STEPS], f"checkpoints {steps}")
    check(run["profile_device_ms"] is not None and run["profile_device_ms"] > 0,
          f"profiled step device ms {run['profile_device_ms']}")
    want = per_frames(GATHER_FRAME, TJ4D_CLI_EVAL_FRAMES)
    check(sorted(evaluated) == [TJ4D_CLI_STEPS], f"evaluated steps {sorted(evaluated)}")
    check(eval_launches == want, f"eval launches {eval_launches}, want {want}")
    result_dict, stats = evaluated.get(TJ4D_CLI_STEPS, ({}, {}))
    check(stats.get("frames") == TJ4D_CLI_EVAL_FRAMES and HEADLINE["TJ4DDataset"] in result_dict
          and all(math.isfinite(v) and 0 <= v <= 100 for v in result_dict.values()),
          f"evaluation: {stats.get('frames')} frames, {result_dict}")
    waits = run["loader_wait_s"]
    result = {
        "config": yaml_path, "frames": TJ4D_CLI_FRAMES, "batch_size": batch,
        "tree_and_infos_s": tree_s,
        "launches": {k: run["launches"][k] + eval_launches[k] for k in eval_launches},
        "launches_by_run": {"train": run["launches"], "eval": eval_launches},
        "steps": run["steps"], "steps_per_s": run["steps_per_s"],
        "steps_per_s_excl_saves": run["steps_per_s_excl_saves"],
        "loader_wait_ms": {"mean": 1e3 * float(np.mean(waits[2:])),
                           "max": 1e3 * float(np.max(waits[2:])),
                           "first_two": [1e3 * w for w in waits[:2]]},
        "augmentation": run["augmentation"], "losses": run["losses"],
        "profiled_step_device_ms": run["profile_device_ms"], "saves": run["saves"],
        "peak_memory_bytes": run["peak_memory_bytes"], "checkpoints": steps,
        "eval_s": eval_s, "eval_ms_per_frame": stats.get("ms_per_frame"),
        "eval_result": result_dict,
    }
    print("  " + json.dumps(result))
    if failures:
        raise AssertionError("; ".join(failures))
    return result


# ---------------------------------------------------------------------------
# RHGM: the Mask2Former segmentor and the hybrid-point tool
# ---------------------------------------------------------------------------

RHGM_IMAGE = (70, 100)  # small_reference_rhgm: not a multiple of any stride
# card vs CPU in f32 with TF32 off: logits within this; a binary mask pixel
# may differ only where the CPU's logit lies within it of 0, and two class
# scores within it of each other may take their top-k ranks in either order
RHGM_TOL = 1e-4
RHGM_FRAMES = 4  # after one warm-up frame
RHGM_RESIZE = 1024  # the reference predictor's MIN_SIZE_TEST: 516 x 1936 -> 1024 x 3842


def compare_instances(ref, got, image_hw, tol: float = RHGM_TOL) -> dict:
    """``instance_inference`` of two forwards of one model (``ref`` on the
    CPU, ``got`` on the card), compared rank by rank where the ranks are
    tie-free: the same label, the score within ``tol`` plus what the
    differing pixels move it, the binary mask equal but at pixels whose
    reference logit lies within ``tol`` of 0. Ranks whose class score lies
    within ``tol`` of a neighbour's are compared through the sorted class
    scores only."""
    k = ref["pred_logits"].shape[-1] - 1
    cls_ref = ref["pred_logits"][0].softmax(-1)[:, :-1].reshape(-1)
    cls_got = got["pred_logits"][0].cpu().softmax(-1)[:, :-1].reshape(-1)
    sorted_ref = torch.sort(cls_ref, descending=True).values
    torch.testing.assert_close(torch.sort(cls_got, descending=True).values, sorted_ref,
                               rtol=0, atol=tol)
    lab_r, sc_r, bin_r = instance_inference(ref["pred_logits"], ref["pred_masks"], image_hw)
    lab_g, sc_g, bin_g = (a.cpu() for a in instance_inference(
        got["pred_logits"], got["pred_masks"], image_hw))
    t = len(lab_r)
    near = (sorted_ref[:-1] - sorted_ref[1:]) < tol  # rank i ties rank i + 1
    tied = near[:t].clone()
    tied[1:] |= near[:t - 1]
    qidx = torch.topk(cls_ref, t).indices // k
    logits = resize_bilinear(ref["pred_masks"][0].permute(1, 2, 0)[None], image_hw)[0]
    flipped = 0
    for r in torch.nonzero(~tied)[:, 0].tolist():
        assert int(lab_g[r]) == int(lab_r[r]), f"rank {r}: label {int(lab_g[r])} vs {int(lab_r[r])}"
        diff = bin_g[r] != bin_r[r]
        n = int(diff.sum())
        if n:
            worst = float(logits[..., qidx[r]][diff].abs().max())
            assert worst < tol, f"rank {r}: a mask pixel flipped at logit {worst}"
            flipped += n
        denom = max(int(bin_r[r].sum()) - n, 1)
        assert abs(float(sc_g[r] - sc_r[r])) <= tol + n / denom, f"rank {r}: score"
    return {"ranks": t, "tied_ranks": int(tied.sum()), "flipped_pixels": flipped}


def phase_small_reference_rhgm(dev):
    """The tiny preset with either pixel decoder, weights from one seed, on
    the card against the CPU (f32, TF32 off): logits, mask logits, then
    instance_inference (``compare_instances``)."""
    img = torch.from_numpy(np.random.RandomState(3).rand(1, *RHGM_IMAGE, 3).astype(np.float32))
    out = {}
    for pd in ("msdeform", "fpn"):
        kw = dict(pixel_decoder=pd, seed=7, **ghp.PRESETS["tiny"])
        cpu_model = Mask2FormerInstance(device="cpu", **kw)
        card_model = Mask2FormerInstance(device=dev, **kw)
        with torch.inference_mode():
            ref = cpu_model(img)
            got = card_model(img.to(dev))
        errs = {k: float((got[k].cpu() - ref[k]).abs().max()) for k in ref}
        for k in ref:
            torch.testing.assert_close(got[k].cpu(), ref[k], rtol=0, atol=RHGM_TOL)
        out[pd] = {"max_abs_err": errs, **compare_instances(ref, got, RHGM_IMAGE)}
        print(f"  {pd}: " + json.dumps(out[pd]))
    return out


def _launches() -> dict:
    return {**quad_sample.launches, **row_scatter.launches}


def segmentor_flops(source, image) -> dict:
    """Multiply-add FLOPs (2 per MAC) of one segmentation, counted by
    ``torch.utils.flop_counter`` from this run's shapes: the whole forward
    and the backbone."""
    from torch.utils.flop_counter import FlopCounterMode

    source.model.requires_grad_(False)  # the counter's module hooks skip tensors without grad
    with FlopCounterMode(display=False) as counter:
        source.segment(image)
    by_module = counter.get_flop_counts()
    backbone = sum(n for name, ops in by_module.items()
                   if name.endswith(".backbone") for n in ops.values())
    return {"total": counter.get_total_flops(), "backbone": backbone}


def run_rhgm_tool(dev, argv, capture: bool):
    """``generate_hybrid_points.main(argv)`` with the peak device memory;
    with ``capture``, the model source's masks of each frame and the source
    itself."""
    captured = {"masks": [], "source": None}
    call = ghp.ModelMaskSource.__call__

    def keep(source, image):
        masks, labels = call(source, image)
        captured["masks"].append((masks, labels))
        captured["source"] = source
        return masks, labels

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    if capture:
        with mock.patch.object(ghp.ModelMaskSource, "__call__", keep):
            res = ghp.main(argv)
    else:
        res = ghp.main(argv)
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"the RHGM path launched a kernel: {launches}")
    res["launches"] = launches
    res["peak_memory_bytes"] = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                                else None)
    return res, captured


def phase_rhgm(dev, preset: str = "large", image_hw=(516, 1936), tj4d_hw=(810, 1280),
               resize=RHGM_RESIZE, frames: int = RHGM_FRAMES):
    """The port's ``tools/generate_hybrid_points.py`` at full width on a
    synthetic VoD tree (one warm-up frame, then ``frames``): swin-L
    Mask2Former with the MSDeformAttn pixel decoder on 1024 x 3842 images,
    random weights from a seed. Random weights score no instance near the
    default 0.5, so the generator would do nothing: the threshold is 0 and
    every one of the 100 instances with a non-empty mask is kept. Then the
    tool with the precomputed source on the first run's masks: the same
    files. Then the VoD dataset reads them under the config's prefix, and
    one TJ4D frame (810 x 1280 PNG, 8 radar dims) goes through the model
    source at the tool's own size. No CUDA kernel of the port runs."""
    cfg = load_config(VOD_YAML)
    data = cfg["DATA_CONFIG"]
    prefix = data["VIRTUAL_POINT_PREFIX"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "vod"
        make_synthetic_kitti(root, num_frames=frames + 1, num_points=2048, num_virtual=64,
                             image_hw=image_hw, structured=True)
        common = ["--dataset", "vod", "--data_root", str(root), "--num_virtual", "100",
                  "--seed", "0", "--confidence_threshold", "0.0"]
        if tuple(image_hw) != ghp._DATASETS["vod"]["image_hw"]:
            common += ["--image_hw", str(image_hw[0]), str(image_hw[1])]
        model_args = ["--mask_source", "model", "--model_preset", preset,
                      "--pixel_decoder", "msdeform", "--device", str(dev)]
        res, captured = run_rhgm_tool(dev, common + model_args + [
            "--resize_shortest", str(resize), "--pts_save_path", str(root / "training" / prefix)],
            capture=True)
        source = captured["source"]
        steady = res["frames"][1:]
        image = ghp.read_rgb01(root / "training/image_2/00000.jpg")
        flops = segmentor_flops(source, image)
        seg_ms = float(np.mean([f["segment_ms"] for f in steady]))
        out["vod"] = {
            "model_hw": list(source.model_hw), "frames": res["frames"],
            "segment_ms": seg_ms, "copy_ms": float(np.mean([f["copy_ms"] for f in steady])),
            "generate_ms": float(np.mean([f["generate_ms"] for f in steady])),
            "frames_per_s": 1e3 / float(np.mean([f["frame_ms"] for f in steady])),
            "peak_memory_bytes": res["peak_memory_bytes"], "launches": res["launches"],
            "flops": flops, "bound_ms": flops["total"] / F32_FLOPS_PER_S * 1e3,
            "bound_by": "operations"}
        if tuple(source.model_hw) != (resize, round(image_hw[1] * resize / image_hw[0])):
            raise AssertionError(f"model input {source.model_hw}")
        if not all(f["virtual"] > 0 and f["real"] > 0 for f in res["frames"]):
            raise AssertionError(f"a frame without points: {res['frames']}")

        # the same masks through the precomputed source: the same files
        masks_dir = Path(tmp) / "masks"
        masks_dir.mkdir()
        for idx, (masks, labels) in zip(ghp.frame_ids(root, "train"), captured["masks"]):
            np.savez(masks_dir / f"{idx}.npz", masks=masks, labels=labels)
        pre, _ = run_rhgm_tool(dev, common + [
            "--mask_source", "precomputed", "--masks_dir", str(masks_dir),
            "--pts_save_path", str(Path(tmp) / "precomputed")], capture=False)
        for idx in ghp.frame_ids(root, "train"):
            a = (root / "training" / prefix / f"{idx}.pkl.npy").read_bytes()
            if a != (Path(tmp) / "precomputed" / f"{idx}.pkl.npy").read_bytes():
                raise AssertionError(f"frame {idx}: model and precomputed files differ")
        out["vod"]["precomputed_generate_ms"] = float(np.mean(
            [f["generate_ms"] for f in pre["frames"]]))

        # the VoD dataset reads them: virtual rows (flags 0, 1) among its points
        data["DATA_PATH"] = str(root)
        create_infos(data, cfg["CLASS_NAMES"])
        ds = build_dataset(data, cfg["CLASS_NAMES"], training=False, logger=create_logger())
        virtual_rows = []
        for i in range(len(ds)):
            item = ds[i]
            pts = item["points"][item["points_valid"].astype(bool)]
            width = np.load(root / "training" / prefix / f"{ds.infos[i]['point_cloud']['lidar_idx']}"
                            ".pkl.npy", allow_pickle=True).item()["virtual_points"].shape[1]
            if width != 15:
                raise AssertionError(f"VoD hybrid points {width} wide, want 15")
            virtual_rows.append(int(((pts[:, -2] == 0) & (pts[:, -1] == 1)).sum()))
        if not all(virtual_rows):
            raise AssertionError(f"virtual rows per frame {virtual_rows}")
        out["vod"]["dataset_virtual_rows"] = virtual_rows

        # one TJ4D frame at the tool's own size
        troot = Path(tmp) / "tj4d"
        make_synthetic_tj4d(troot, num_frames=1, num_points=2048, image_hw=tj4d_hw)
        targs = ["--dataset", "tj4d", "--data_root", str(troot), "--seed", "0",
                 "--confidence_threshold", "0.0", "--pts_save_path", str(troot / "hybrid")]
        if tuple(tj4d_hw) != ghp._DATASETS["tj4d"]["image_hw"]:
            targs += ["--image_hw", str(tj4d_hw[0]), str(tj4d_hw[1])]
        tres, _ = run_rhgm_tool(dev, targs + model_args, capture=False)
        f = next((troot / "hybrid").iterdir())
        d = np.load(f, allow_pickle=True).item()
        if d["virtual_points"].shape[1] != 16 or not len(d["virtual_points"]):
            raise AssertionError(f"TJ4D hybrid points {d['virtual_points'].shape}, want (>0, 16)")
        out["tj4d"] = {"frames": tres["frames"], "peak_memory_bytes": tres["peak_memory_bytes"],
                       "launches": tres["launches"]}
    out["launches"] = {k: out["vod"]["launches"][k] + out["tj4d"]["launches"][k]
                       for k in out["vod"]["launches"]}
    for name in ("vod", "tj4d"):
        for f in out[name]["frames"]:
            print(f"  {name} {f['id']}: segment {f['segment_ms']:.1f} ms, copy "
                  f"{f['copy_ms']:.1f} ms, generator {f['generate_ms']:.1f} ms, masks "
                  f"{f['masks']}, virtual {f['virtual']}, real {f['real']}")
    v = out["vod"]
    print(f"  vod: {v['frames_per_s']:.3f} frames/s through the tool, segmentor "
          f"{v['segment_ms']:.1f} ms against its bound {v['bound_ms']:.1f} ms "
          f"({v['flops']['total'] / 1e12:.2f} TFLOP, backbone "
          f"{v['flops']['backbone'] / 1e12:.2f}), peak {v['peak_memory_bytes']} B; "
          f"tj4d peak {out['tj4d']['peak_memory_bytes']} B")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity phases: full f32
    torch.backends.cudnn.allow_tf32 = False
    failed, report = [], {}

    def phase(name, fn, *a):
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        try:
            report[name] = fn(*a)
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)
        except Exception:
            traceback.print_exc()
            print(f"[{name}] FAILED", flush=True)
            failed.append(name)

    phase("card", card_line)
    print("  " + str(report.get("card")))
    phase("build", native.build, KERNEL_SOURCES)
    for name, r in (report.get("build") or {}).items():
        print(f"  {name}: {r['seconds']:.1f} s\n" + r["ptxas"].strip())
    phase("kernel_vs_plain", phase_kernel_vs_plain, dev)
    phase("kernel_vs_plain_bwd", phase_kernel_vs_plain_bwd, dev)
    phase("taps", phase_taps, dev)
    phase("kernel_vs_plain_reduce", phase_kernel_vs_plain_reduce, dev)
    torch.cuda.empty_cache()
    phase("small_reference", phase_small_reference, dev)
    phase("small_reference_train", phase_small_reference_train, dev)
    phase("serve", phase_serve, dev, vod_pallas_config(), GATHER_FRAME)
    torch.cuda.empty_cache()
    phase("train", phase_train, dev, vod_pallas_config(), 2)
    torch.cuda.empty_cache()
    phase("kernel_vs_plain_polar", phase_kernel_vs_plain_polar, dev)
    phase("small_reference_polar", phase_small_reference_polar, dev)
    phase("polar_vs_gather", phase_polar_vs_gather, dev)
    torch.cuda.empty_cache()
    phase("serve_polar", phase_serve, dev, vod_polar_config(), POLAR_FRAME)
    torch.cuda.empty_cache()
    phase("train_polar", phase_train, dev, vod_polar_config(), 3)
    torch.cuda.empty_cache()
    phase("small_reference_eval", phase_small_reference_eval, dev)
    phase("eval", phase_eval, dev, "configs/hgsfusion_vod_pallas.yaml", GATHER_FRAME,
          vod_pallas_config())
    torch.cuda.empty_cache()
    phase("eval_polar", phase_eval, dev, "configs/hgsfusion_vod_polar.yaml", POLAR_FRAME,
          vod_polar_config())
    torch.cuda.empty_cache()
    phase("small_reference_xla", phase_small_reference_xla, dev)
    phase("train_cli", phase_train_cli, dev)
    torch.cuda.empty_cache()
    phase("kernel_vs_plain_scatter", phase_kernel_vs_plain_scatter, dev)
    torch.cuda.empty_cache()
    phase("bench_scatter", phase_bench_scatter, dev)
    torch.cuda.empty_cache()
    phase("small_reference_tj4d", phase_small_reference_tj4d, dev)
    for view, path, per_frame in (("pallas", "serve_tj4d", GATHER_FRAME),
                                  ("polar", "serve_tj4d_polar", POLAR_FRAME)):
        cfg = tj4d_config(view)
        phase(path, phase_serve, dev, cfg, per_frame, tj4d_serve_batch(cfg))
        torch.cuda.empty_cache()
    phase("train_cli_tj4d", phase_train_cli_tj4d, dev)
    torch.cuda.empty_cache()
    phase("eval_tj4d_polar", phase_eval, dev, TJ4D_YAMLS["polar"], POLAR_FRAME)
    torch.cuda.empty_cache()
    phase("small_reference_rhgm", phase_small_reference_rhgm, dev)
    phase("rhgm", phase_rhgm, dev)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1

    def summed(rows, key):
        vals = [r[key] for r in rows if "ms" in r]
        return None if None in vals else sum(vals)

    def kernel_row(name, source, replaces, rows, polar_rows=None):
        # per frame or step: the bf16 calls of the gather path (A, B) summed,
        # and of the polar path (its three maps) beside them
        timed = [r for r in rows if "ms" in r]
        polar_block = {} if polar_rows is None else {"polar": {
            "max_abs_err": max(r["max_abs_err"] for r in polar_rows),
            **{k: summed(polar_rows, k) for k in ("ms", "route_ms", "plain_ms", "bound_ms",
                                                  "library_ms") if k in polar_rows[0]}}}
        by_path = {path: report[path]["launches"].get(name, 0) for path in MAIN_PATHS}
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": summed(rows, "ms"), "plain_ms": summed(rows, "plain_ms"),
            "bound_ms": summed(rows, "bound_ms"),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in timed)
            else "operations",
            "library_ms": summed(rows, "library_ms"),
            **{k: summed(rows, k) for k in ("route_ms",) if k in timed[0]},
            **{k: timed[0][k] for k in ("library", "library_pair", "library_pair_ms",
                                        "sampling_route_ms") if k in timed[0]},
            **polar_block,
        }

    polar = report["kernel_vs_plain_polar"]
    kernels = [
        kernel_row(quad_sample.KERNEL, "hgsfusion_tpu_torch/csrc/quad_sample.cu",
                   "hgsfusion_tpu/ops/pallas_sample.py:108",
                   [r for r in report["kernel_vs_plain"]
                    if r["case"] in FLAGSHIP_SHAPES and r["dtype"] == "bfloat16"],
                   [r for r in polar["fwd"] if r["dtype"] == "bfloat16"]),
        kernel_row(quad_sample.BWD_KERNEL, "hgsfusion_tpu_torch/csrc/quad_sample_bwd.cu",
                   "hgsfusion_tpu/ops/pallas_sample.py:226",
                   [r for r in report["kernel_vs_plain_bwd"] if "ms" in r], polar["bwd"]),
        kernel_row(quad_sample.REDUCE_KERNEL, "hgsfusion_tpu_torch/csrc/quad_sample_reduce.cu",
                   "_bench_gather_pallas.py:162",
                   [r for r in report["kernel_vs_plain_reduce"]["rows"] if "ms" in r]),
        kernel_row(row_scatter.KERNEL, "hgsfusion_tpu_torch/csrc/row_scatter_add.cu",
                   "_bench_scatter_pallas.py:69",
                   [r for r in report["kernel_vs_plain_scatter"] if "ms" in r]),
    ]
    kernels[-1]["cases"] = {r["case"]: {k: r[k] for k in (
        "ms", "binning_ms", "kernel_only_ms", "plain_ms", "library_ms", "bound_ms")}
        for r in report["kernel_vs_plain_scatter"] if "ms" in r}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": report["card"], "kernels": kernels, **report}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(report["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
