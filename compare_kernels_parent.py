#!/usr/bin/env python3
"""Hold this tree's int8 convolution (W8, ``conv2d_w8a8``) and depth
backward (D2, ``quad_sample_depth_bwd``) against another tree's on one
NVIDIA GPU: outputs bit for bit or within their bounds, kernel and route
times in turns, and a served w8a8 frame.

    python3 compare_kernels_parent.py PARENT_DIR [--out results.json]

PARENT_DIR holds a checkout of another commit (``git archive <commit> |
tar -x -C PARENT_DIR``). Its ``hgsfusion_tpu_torch`` is imported under
another name, its ``torch.library`` ops registered under that name as
namespace, and it builds its kernels into its own ``_build/``. Times are
taken in turns (parent, this tree, this tree, parent), kernels from CUDA
graph replays (``chip_smoke.graph_ms``).

- W8, at each distinct convolution of the VoD ResNet-101 at 516 x 1936
  (``chip_smoke.backbone_conv_shapes``) on ``chip_smoke.w8a8_input`` in
  bf16, and on ``chip_smoke.w8a8_activation`` (its largest |x| not
  special): the parent's route (its ``quantize_activation``, then its int8
  kernel) equal to this tree's op on x with ``activation_scale`` bit for
  bit; each kernel alone and each route; cuDNN's bf16 ``F.conv2d`` and
  ``torch._int_mm`` on im2col columns as yardsticks; all summed over the
  backbone's 104 convolutions.
- D2, at the VoD gather maps A and B (80 bins, the flagship grid read in
  place, bf16): each tree's gradient within ``chip_smoke.depth_case``'s
  bound of the plain version and equal from call to call; each tree's
  time and its kernels' split (``torch.profiler``).
- The served frame of ``hgsfusion_vod_w8a8.yaml`` (gather view, weights
  from seed 0 copied into both trees' models, the flagship batch): the
  backbone's four taps equal bit for bit, and each tree's frames through
  ``profile_serve.profile_frames`` with the peak device memory.

Exits non-zero when anything differs or leaves its bound.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import types
from pathlib import Path

import torch
import torch.nn.functional as F

import chip_smoke as cs
import hgsfusion_tpu_torch
from hgsfusion_tpu_torch.ops import conv_int8, depth_sample, library
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


def compare_frame(dev, parent):
    """The served w8a8 frame from each tree: backbone taps and profiles."""
    pkgs = {"parent": parent.__name__, "change": hgsfusion_tpu_torch.__name__}
    state, taps, rows, ok = None, {}, [], True
    for label in TURNS:
        pkg = pkgs[label]
        config = importlib.import_module(f"{pkg}.config")
        cfg = config.model_config_from_yaml(config.load_config(cs.W8A8_YAML))
        model = importlib.import_module(f"{pkg}.models.detector").HGSFusionModel(
            cfg, device=dev, seed=0)
        if state is None:
            state = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(state)
        batch = importlib.import_module(f"{pkg}.synthetic").flagship_batch(cfg)
        resnet = importlib.import_module(f"{pkg}.models.resnet")
        backbone = model.fusion_vfe.image_vfe.ffn.ddn.model.backbone
        with torch.inference_mode():
            got = backbone(resnet.preprocess_images(model.batch_to_device(batch)["images"]))
        if label not in taps:
            taps[label] = [t.clone() for t in got]
        del got
        torch.cuda.reset_peak_memory_stats(dev)
        r = {"tree": label, **profile_frames(model, batch, frames=3),
             "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
        r.pop("top_ops")
        del model
        print("  " + json.dumps(r), flush=True)
        rows.append(r)
        torch.cuda.empty_cache()
    equal = [bool(torch.equal(a, b)) for a, b in zip(taps["parent"], taps["change"])]
    print("  " + json.dumps({"backbone_taps_equal": equal}), flush=True)
    ok = all(equal)
    return {"frames": rows, "backbone_taps_equal": equal}, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, help="the other tree's root")
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels_parent: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    parent = load_tree(args.parent.resolve(), "parent_tree")
    results, ok = {"card": cs.card_line()}, True
    for name, fn in (("w8a8", compare_w8a8), ("depth_bwd", compare_depth),
                     ("w8a8_frame", compare_frame)):
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
