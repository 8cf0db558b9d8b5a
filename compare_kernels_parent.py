#!/usr/bin/env python3
"""Hold this tree's kernels against another tree's on one NVIDIA GPU:
outputs bit for bit (or within their bounds), kernel and route times in
turns, and served frames.

    python3 compare_kernels_parent.py PARENT_DIR [--out results.json] [--parts NAME,...]

PARENT_DIR holds a checkout of another commit (``git archive <commit> |
tar -x -C PARENT_DIR``). Its ``hgsfusion_tpu_torch`` is imported under
another name, its ``torch.library`` ops registered under that name as
namespace, and it builds its kernels into its own ``_build/``. Times are
taken in turns (parent, this tree, this tree, parent), kernels from CUDA
graph replays (``chip_smoke.graph_ms``). The parts, all by default, in
this order:

- ``sass``: each tree's ``csrc/quad_sample_reduce.cu`` and
  ``csrc/nms_lazy.cu`` built here, the ``ptxas`` lines that name C7518
  (serialised ``wgmma``), and each kernel function's instructions counted
  from ``cuobjdump -sass`` (all, ``I2F``, ``PRMT``, ``FADD``, ``FFMA``,
  ``HGMMA``).
- ``nms``: rotated NMS (``hgsfusion::nms_lazy``) on ``chip_smoke``'s six
  cases at 4,096 candidates: the keep sets equal bit for bit; the op and
  ``class_agnostic_nms`` around it timed in turns.
- ``reduce``: P3-q8 (``quad_sample_reduce_q8_fwd``) and P3
  (``quad_sample_reduce_fwd``) at the flagship gather groups in bf16 (the
  flagship grid read in place, ``chip_smoke.reduce_q8_case``'s inputs):
  outputs equal bit for bit, times in turns; P3-q8's digests on
  ``chip_smoke.reduce_q8_ragged`` in bf16 and f16.
- ``frames``: the served frames of ``hgsfusion_vod_q8.yaml`` and
  ``hgsfusion_vod_w8a8.yaml`` (gather view, weights from seed 0 copied into
  both trees' models, the flagship batch): the head outputs equal bit for
  bit (and the w8a8 backbone's four taps), each tree's frames through
  ``profile_serve.profile_frames`` with the peak device memory.
- ``w8a8``: W8, at each distinct convolution of the VoD ResNet-101 at 516
  x 1936 (``chip_smoke.backbone_conv_shapes``) on ``chip_smoke.w8a8_input``
  in bf16, and on ``chip_smoke.w8a8_activation`` (its largest |x| not
  special): the parent's route (its ``quantize_activation``, then its int8
  kernel) equal to this tree's op on x with ``activation_scale`` bit for
  bit; each kernel alone and each route; cuDNN's bf16 ``F.conv2d`` and
  ``torch._int_mm`` on im2col columns as yardsticks; all summed over the
  backbone's 104 convolutions.
- ``depth_bwd``: D2, at the VoD gather maps A and B (80 bins, the flagship
  grid read in place, bf16): each tree's gradient within
  ``chip_smoke.depth_case``'s bound of the plain version and equal from
  call to call; each tree's time and its kernels' split
  (``torch.profiler``).
- ``fps``: farthest-point sampling (``hgsfusion::farthest_point_sample``)
  on ``chip_smoke.fps_inputs``' six cases (8,192 points -> 1,024
  keypoints): the indices equal bit for bit; at ``tune_fps.TIMED`` (B=1,
  B=2, 16,384 points, the proposal-centric mask) the op in turns, and this
  tree's chain floor (``tune_fps.CHAIN_FLOOR``: its kernel without the
  distance updates); then this tree's PV-RCNN and PV-RCNN++ (seed 0, the
  flagship batch) served with each tree's FPS in turns: the detections
  equal, each frame's device time (``torch.profiler``, the kernels' own
  time summed).

Exits non-zero when anything differs or leaves its bound.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as cs
import hgsfusion_tpu_torch
import tune_fps
from hgsfusion_tpu_torch.models import pvrcnn
from hgsfusion_tpu_torch.ops import conv_int8, depth_sample, library, nms, pointnet2
from hgsfusion_tpu_torch.ops.grid_sample import quantize_per_channel_int8
from hgsfusion_tpu_torch.profile_serve import kernel_split_ms, profile_frames

TURNS = ("parent", "change", "change", "parent")


def load_tree(root: Path, alias: str):
    """The package ``hgsfusion_tpu_torch`` of the tree at ``root``, imported
    as ``alias``, its ``ops/library.py`` registering its ops in the
    namespace ``alias``."""
    pkg = root / "hgsfusion_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    ops = importlib.import_module(f"{alias}.ops")
    path = pkg / "ops" / "library.py"
    lib = types.ModuleType(f"{alias}.ops.library")
    lib.__file__, lib.__package__ = str(path), f"{alias}.ops"
    sys.modules[lib.__name__] = lib
    src = path.read_text().replace('NAMESPACE = "hgsfusion"', f'NAMESPACE = "{alias}"')
    exec(compile(src, str(path), "exec"), lib.__dict__)
    ops.library = lib
    return module


def summed(rows, key):
    return sum(r[key] * r["count"] for r in rows)


def parent_route(plib, pconv, x, wt, wk, args):
    """The parent's w8a8 convolution of ``x`` in bf16: its
    ``quantize_activation``, then its int8 kernel."""
    q, ax = pconv.quantize_activation(x)
    return plib.conv2d_w8a8(q, wt, ax, wk, *args, torch.bfloat16)


def change_route(x, wt, wk, args):
    """This tree's: ``activation_scale``, then the op on x."""
    return library.conv2d_w8a8(x, wt, conv_int8.activation_scale(x), wk, *args, torch.bfloat16)


def compare_w8a8(dev, parent):
    """The W8 rows (see the module's docstring) and whether all are equal."""
    plib = importlib.import_module(f"{parent.__name__}.ops.library")
    pconv = importlib.import_module(f"{parent.__name__}.ops.conv_int8")
    gen = torch.Generator().manual_seed(9)
    rows, ok = [], True
    for key, count in cs.backbone_conv_shapes(cs.vod_pallas_config()).items():
        cin, h, w, cout, k, s, p, d = key
        x = cs.w8a8_input((1, h, w, cin), gen, dev).to(torch.bfloat16)
        qw = torch.randint(-127, 128, (cout, cin, k, k), generator=gen, dtype=torch.int8).to(dev)
        wt = conv_int8.pack_weight(qw)
        wk = (torch.rand(cout, generator=gen) * 0.01 + 1e-4).to(dev)
        args = ((k, k), (s, s), (p, p), (d, d))
        ax = conv_int8.activation_scale(x)
        q, pax = pconv.quantize_activation(x)
        calls = {
            "parent": lambda: plib.conv2d_w8a8(q, wt, pax, wk, *args, torch.bfloat16),
            "change": lambda: library.conv2d_w8a8(x, wt, ax, wk, *args, torch.bfloat16)}
        routes = {"parent": lambda: parent_route(plib, pconv, x, wt, wk, args),
                  "change": lambda: change_route(x, wt, wk, args)}
        # and on a served-like activation, whose largest |x| is not special
        xa = cs.w8a8_activation((1, h, w, cin), gen, dev, stem=cin % 16 != 0)
        row = {"shape": list(key), "count": count,
               "equal": bool(torch.equal(calls["parent"](), calls["change"]())),
               "equal_activation": bool(torch.equal(
                   parent_route(plib, pconv, xa, wt, wk, args),
                   change_route(xa, wt, wk, args)))}
        del xa
        ok = ok and row["equal"] and row["equal_activation"]
        for label in TURNS:
            row.setdefault(f"{label}_ms", []).append(cs.graph_ms(calls[label], iters=10,
                                                                 replays=2))
            row.setdefault(f"{label}_route_ms", []).append(cs.graph_ms(routes[label], iters=10,
                                                                       replays=2))
        xb = x.permute(0, 3, 1, 2)
        wb = qw.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        row["cudnn_bf16_ms"] = cs.cuda_ms(lambda: F.conv2d(xb, wb, None, s, p, d), iters=10)
        cols = F.unfold(q.permute(0, 3, 1, 2).to(torch.float16), k, dilation=d, padding=p,
                        stride=s)[0].t().to(torch.int8)
        pad = -cols.shape[1] % 8
        cols = F.pad(cols, (0, pad)).contiguous()
        w_cols = F.pad(qw.reshape(cout, -1), (0, pad)).contiguous()
        try:  # a yardstick: cuBLAS's int8 product may refuse a shape
            row["int_mm_ms"] = cs.cuda_ms(lambda: torch._int_mm(cols, w_cols.t()), iters=10)
        except RuntimeError:
            row["int_mm_ms"] = None
        for label in ("parent", "change"):
            for kind in ("", "_route"):
                times = row[f"{label}{kind}_ms"]
                row[f"{label}{kind}_ms"] = min(times)
                row[f"{label}{kind}_ms_turns"] = times
        print("  " + json.dumps(row), flush=True)
        rows.append(row)
        del x, q, cols, w_cols, xb, wb
        torch.cuda.empty_cache()
    total = {k: summed(rows, k) for k in ("parent_ms", "change_ms", "parent_route_ms",
                                          "change_route_ms", "cudnn_bf16_ms")}
    total["int_mm_ms"] = (None if any(r["int_mm_ms"] is None for r in rows)
                          else summed(rows, "int_mm_ms"))
    print("  " + json.dumps({"backbone": total}), flush=True)
    return {"rows": rows, "backbone": total}, ok


def compare_depth(dev, parent):
    """The D2 rows (see the module's docstring) and whether all are within
    their bounds and equal from call to call."""
    plib = importlib.import_module(f"{parent.__name__}.ops.library")
    grid = cs.flagship_grid(dev)
    gen = torch.Generator().manual_seed(21)
    trees = {"parent": plib, "change": library}
    rows, ok = [], True
    for name, shape in cs.FLAGSHIP_SHAPES.items():
        b, h, w, c = shape
        d = cs.DEPTH_BINS
        f = torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
        probs = torch.softmax(2 * torch.randn(shape[:3] + (d + 1,), generator=gen), -1)[..., :d]
        probs = probs.to(torch.bfloat16).contiguous().to(dev)
        _, key, _ = library.quad_sample_depth_fwd(f, probs, grid, taps=True)
        n = key.numel()
        ct = torch.randn((n, c), generator=gen).to(torch.bfloat16).to(dev)
        bins = depth_sample.depth_bins(key, (b, h + 2, w + 2, c))
        want = depth_sample.quad_sample_depth_bwd_plain(ct, f, grid, d)
        s_abs = depth_sample.quad_sample_depth_bwd_plain(ct.float().abs(), f.float().abs(),
                                                         grid, d)
        counts = (bins[1][1:] - bins[1][:-1]).view(b, h + 2, w + 2)
        n_max = int((counts[:, 1:-1, 1:-1] + counts[:, 1:-1, :-2] + counts[:, :-2, 1:-1]
                     + counts[:, :-2, :-2]).max())
        btol = cs.F32_TOL * (1 + float(want.abs().max())) + (n_max + c) * cs.F32_U * s_abs
        row = {"case": name, "shape": list(shape), "queries": n, "max_adds_per_pixel": n_max}
        for label, lib in trees.items():
            got = lib.quad_sample_depth_bwd(ct, f, grid, d, bins)
            again = lib.quad_sample_depth_bwd(ct, f, grid, d, bins)
            row[f"{label}_err_over_tol"] = float(((got - want).abs() / btol).max())
            row[f"{label}_rerun_equal"] = bool(torch.equal(got, again))
            ok = ok and row[f"{label}_err_over_tol"] <= 1.0 and row[f"{label}_rerun_equal"]
            del got, again
        del want, s_abs, btol
        for label in TURNS:
            lib = trees[label]
            row.setdefault(f"{label}_ms", []).append(
                cs.graph_ms(lambda: lib.quad_sample_depth_bwd(ct, f, grid, d, bins)))
        for label, lib in trees.items():
            row[f"{label}_phase_ms"] = kernel_split_ms(
                lambda: lib.quad_sample_depth_bwd(ct, f, grid, d, bins))
        print("  " + json.dumps(row), flush=True)
        rows.append(row)
        del f, probs, ct, bins, key
        torch.cuda.empty_cache()
    return rows, ok


def compare_frames(dev, parent):
    """The served q8 and w8a8 frames from each tree: head outputs (and the
    w8a8 backbone's taps) bit for bit, and profiles."""
    pkgs = {"parent": parent.__name__, "change": hgsfusion_tpu_torch.__name__}
    out, ok = {}, True
    for yaml in (cs.Q8_YAML, cs.W8A8_YAML):
        state, kept, rows = None, {}, []
        for label in TURNS:
            pkg = pkgs[label]
            config = importlib.import_module(f"{pkg}.config")
            cfg = config.model_config_from_yaml(config.load_config(yaml))
            model = importlib.import_module(f"{pkg}.models.detector").HGSFusionModel(
                cfg, device=dev, seed=0)
            if state is None:
                state = {k: v.clone() for k, v in model.state_dict().items()}
            model.load_state_dict(state)
            batch = importlib.import_module(f"{pkg}.synthetic").flagship_batch(cfg)
            resnet = importlib.import_module(f"{pkg}.models.resnet")
            backbone = model.fusion_vfe.image_vfe.ffn.ddn.model.backbone
            model.eval()
            if label not in kept:
                with torch.inference_mode():
                    b = model.batch_to_device(batch)
                    taps = [t.clone() for t in backbone(resnet.preprocess_images(b["images"]))]
                    preds = {k: v.clone() for k, v in model(b).items()}
                kept[label] = (taps, preds)
            torch.cuda.reset_peak_memory_stats(dev)
            r = {"tree": label, **profile_frames(model, batch, frames=3),
                 "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
            r.pop("top_ops")
            del model
            print("  " + json.dumps(r), flush=True)
            rows.append(r)
            torch.cuda.empty_cache()
        (ptaps, ppreds), (ctaps, cpreds) = kept["parent"], kept["change"]
        res = {"frames": rows,
               "backbone_taps_equal": [bool(torch.equal(a, b)) for a, b in zip(ptaps, ctaps)],
               "preds_equal": {k: bool(torch.equal(ppreds[k], cpreds[k])) for k in ppreds}}
        print("  " + json.dumps({yaml: {k: res[k] for k in ("backbone_taps_equal",
                                                              "preds_equal")}}), flush=True)
        ok = ok and all(res["backbone_taps_equal"]) and all(res["preds_equal"].values())
        out[Path(yaml).stem] = res
    return out, ok


NMS_CASES = ("worst", "realistic", "batch2", "degenerate", "none_valid", "max_keep")


def nms_inputs(dev, name):
    """(boxes, valid, max_keep) of ``chip_smoke.phase_kernel_vs_plain_nms``'s
    case ``name``."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    worst = t(cs.clustered_boxes(cs.NMS_K, 800, 0))[None]
    all_valid = torch.ones((1, cs.NMS_K), dtype=torch.bool, device=dev)
    if name == "realistic":
        return worst, torch.arange(cs.NMS_K, device=dev)[None] < 64, cs.NMS_KEEP
    if name == "batch2":
        pair = t(np.stack([cs.clustered_boxes(cs.NMS_K, 800, 1),
                           cs.clustered_boxes(cs.NMS_K, 1600, 2)]))
        return pair, all_valid.expand(2, -1).contiguous(), cs.NMS_KEEP
    if name == "degenerate":
        return t(cs.degenerate_boxes(cs.NMS_K, 3))[None], all_valid, cs.NMS_KEEP
    if name == "none_valid":
        return worst, torch.zeros_like(all_valid), cs.NMS_KEEP
    if name == "max_keep":
        return worst, all_valid, 37
    return worst, all_valid, cs.NMS_KEEP


def compare_nms(dev, parent):
    """Each tree's NMS op on the six cases: keep sets bit for bit, the op
    and ``class_agnostic_nms`` with it in turns."""
    mods = {"parent": importlib.import_module(f"{parent.__name__}.ops.nms"), "change": nms}
    rows, ok = [], True
    for name in NMS_CASES:
        boxes, valid, max_keep = nms_inputs(dev, name)
        k = boxes.shape[1]
        scores = torch.linspace(1.0, 0.5, k, device=dev).expand(boxes.shape[0], k)
        scores = torch.where(valid, scores, torch.zeros_like(scores))
        keeps = {label: m.nms_lazy_op(boxes, valid, cs.NMS_THRESH, max_keep)
                 for label, m in mods.items()}
        row = {"case": name, "kept": keeps["change"].sum(1).tolist(),
               "equal": bool(torch.equal(keeps["parent"], keeps["change"]))}
        ok = ok and row["equal"]
        for label in TURNS:
            m = mods[label]
            row.setdefault(f"{label}_ms", []).append(cs.graph_ms(
                lambda: m.nms_lazy_op(boxes, valid, cs.NMS_THRESH, max_keep), iters=3,
                replays=2))
            row.setdefault(f"{label}_route_ms", []).append(cs.cuda_ms(
                lambda: m.class_agnostic_nms(scores, boxes, 0.1, cs.NMS_THRESH, k, max_keep),
                iters=5, warmup=1))
        print("  " + json.dumps(row), flush=True)
        rows.append(row)
    return rows, ok


def compare_reduce(dev, parent):
    """P3-q8 and P3 at the flagship groups (bf16) from each tree, bit for
    bit and in turns; P3-q8's digests on the ragged case."""
    plib = importlib.import_module(f"{parent.__name__}.ops.library")
    gen = torch.Generator().manual_seed(5)
    uv = cs.flagship_grid(dev)[..., 0:2]
    maps = [torch.randn(shape, generator=gen).to(dev) for shape in cs.FLAGSHIP_SHAPES.values()]
    qs = [quantize_per_channel_int8(m) for m in maps]
    csum = sum(q.shape[-1] for q, _ in qs)
    kernel = (torch.randn((csum, cs.REDUCE_O), generator=gen) * csum ** -0.5).to(dev)
    bias = torch.randn(cs.REDUCE_O, generator=gen).to(dev)
    q8 = (cs.reduce_groups([q for q, _ in qs]),
          (kernel * torch.cat([s for _, s in qs])[:, None]).to(torch.bfloat16).contiguous())
    bf16 = (cs.reduce_groups([m.to(torch.bfloat16) for m in maps]),
            kernel.to(torch.bfloat16).contiguous())
    rows, ok = [], True
    for name, (groups, kmat), op in (
            ("p3_q8", q8, lambda lib, g, k: lib.quad_sample_reduce_q8_fwd(uv, g, k, bias)),
            ("p3_bf16", bf16, lambda lib, g, k: lib.quad_sample_reduce_fwd(uv, g, k, bias))):
        libs = {"parent": plib, "change": library}
        outs = {label: op(lib, groups, kmat) for label, lib in libs.items()}
        row = {"case": name, "equal": bool(torch.equal(outs["parent"], outs["change"]))}
        ok = ok and row["equal"]
        del outs
        for label in TURNS:
            lib = libs[label]
            row.setdefault(f"{label}_ms", []).append(cs.graph_ms(
                lambda: op(lib, groups, kmat), iters=10, replays=2))
        print("  " + json.dumps(row), flush=True)
        rows.append(row)
    digests = {}
    for dtype in (torch.bfloat16, torch.float16):
        uv_r, groups, kmat, bias_r = cs.reduce_q8_ragged(dev, dtype)
        d = {label: cs.output_digest(lib.quad_sample_reduce_q8_fwd(uv_r, groups, kmat, bias_r))
             for label, lib in (("parent", plib), ("change", library))}
        digests[str(dtype).replace("torch.", "")] = d
        ok = ok and d["parent"] == d["change"]
    print("  " + json.dumps({"ragged_digests": digests}), flush=True)
    return {"rows": rows, "ragged_digests": digests}, ok


SASS_OPS = ("I2F", "PRMT", "FADD", "FFMA", "HGMMA")


def sass_counts(lib_path) -> dict:
    """{kernel function: {"instructions": n, op: n for SASS_OPS}} from
    ``cuobjdump -sass`` of a built library (each op counted with its
    modifiers, e.g. I2F.S8 as I2F)."""
    tool = shutil.which("cuobjdump") or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
                                            / "bin" / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"instructions": 0, **{op: 0 for op in SASS_OPS}}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if m and fn is not None:
            counts[fn]["instructions"] += 1
            op = m.group(1)
            if op in counts[fn]:
                counts[fn][op] += 1
    return counts


def compare_sass(dev, parent):
    """Each tree's reduce and NMS kernels built here: C7518 lines and SASS
    counts (see the module's docstring)."""
    out = {}
    for label, pkg in (("parent", parent.__name__), ("change", hgsfusion_tpu_torch.__name__)):
        native = importlib.import_module(f"{pkg}.native")
        report = native.build(["quad_sample_reduce", "nms_lazy"])
        out[label] = {}
        for name in ("quad_sample_reduce", "nms_lazy"):
            log = report.get(name, {}).get("ptxas", "")
            out[label][name] = {
                "c7518": [ln.strip() for ln in log.splitlines() if "C7518" in ln],
                "sass": {fn: c for fn, c in sass_counts(native.library_path(name)).items()
                         if "kernel" in fn or "mma" in fn}}
        print("  " + json.dumps({label: out[label]}), flush=True)
    return out, True


def compare_fps(dev, parent):
    """Each tree's FPS op on the six cases: indices bit for bit, the timed
    cases in turns beside this tree's chain floor."""
    libs = {"parent": importlib.import_module(f"{parent.__name__}.ops.library"),
            "change": library}
    floor = tune_fps.chain_floor()
    rows, ok = [], True
    for case in cs.FPS_CASES:
        xyz, valid = cs.fps_inputs(case, dev)
        outs = {label: lib.farthest_point_sample(xyz, valid, cs.FPS_K)
                for label, lib in libs.items()}
        row = {"case": case, "batch": valid.shape[0], "valid": int(valid.sum()),
               "cluster": library.fps_plan(valid.shape[1])[0],
               "equal": bool(torch.equal(outs["parent"], outs["change"]))}
        ok = ok and row["equal"]
        if case in tune_fps.TIMED:
            for label in TURNS:
                lib = libs[label]
                row.setdefault(f"{label}_ms", []).append(cs.graph_ms(
                    lambda: lib.farthest_point_sample(xyz, valid, cs.FPS_K), iters=5,
                    replays=2))
            row["chain_floor_ms"] = cs.graph_ms(
                lambda: tune_fps.launch(floor, xyz, valid, cs.FPS_K), iters=5, replays=2)
        print("  " + json.dumps(row), flush=True)
        rows.append(row)
    fps_of = {"parent": lambda xyz, valid, k: libs["parent"].farthest_point_sample(
        xyz.float().contiguous(), valid.contiguous(), k), "change": pointnet2.farthest_point_sample}
    for name in ("pvrcnn", "pvrcnnpp"):
        cfg = cs.zoo_config(name)
        batch = cs.flagship_batch(cfg)
        model = cs.build_network(cs.bench.ZOO[name][1], cfg, device=dev, seed=0)
        row, dets = {"model": name}, {}
        for label in TURNS:
            with mock.patch.object(pvrcnn, "farthest_point_sample", fps_of[label]):
                model.serve(batch)  # warm-up
                if label not in dets:
                    dets[label] = {k: v.clone() for k, v in model.serve(batch).items()}
                row.setdefault(f"{label}_frame_device_ms", []).append(
                    cs.profiled_device_ms(lambda: model.serve(batch)))
        row["detections_equal"] = all(torch.equal(v, dets["change"][k])
                                      for k, v in dets["parent"].items())
        ok = ok and row["detections_equal"]
        del model
        torch.cuda.empty_cache()
        print("  " + json.dumps(row), flush=True)
        rows.append(row)
    return rows, ok


PARTS = {"sass": compare_sass, "nms": compare_nms, "reduce": compare_reduce,
         "frames": compare_frames, "w8a8": compare_w8a8, "depth_bwd": compare_depth,
         "fps": compare_fps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, help="the other tree's root")
    ap.add_argument("--out", help="also write the results to this JSON file")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated parts to run, of {list(PARTS)} (all by default)")
    args = ap.parse_args(argv)
    parts = [p for p in args.parts.split(",") if p]
    if set(parts) - set(PARTS):
        ap.error(f"unknown parts {sorted(set(parts) - set(PARTS))}")
    if not torch.cuda.is_available():
        print("compare_kernels_parent: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    parent = load_tree(args.parent.resolve(), "parent_tree")
    results, ok = {"card": cs.card_line()}, True
    for name, fn in PARTS.items():
        if name not in parts:
            continue
        print(f"[{name}]", flush=True)
        results[name], good = fn(dev, parent)
        ok = ok and good
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"all_equal": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
