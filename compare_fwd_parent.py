#!/usr/bin/env python3
"""Hold this tree's forward sampler route against another tree's on one
NVIDIA GPU: outputs and map gradients bit for bit, kernel and route times,
and a profiled polar frame.

    python3 compare_fwd_parent.py PARENT_DIR [--out results.json]

PARENT_DIR holds a checkout of another commit (``git archive <commit> |
tar -x -C PARENT_DIR``). Its ``hgsfusion_tpu_torch`` is imported under
another name and builds its kernels into its own ``_build/``. On the same
inputs (the flagship grid's (u, v) read in place with maps from seed 1 at
the VoD gather maps A and B; the polar near grid's (u, v) in place and pass
3's coordinates with maps from seed 3 at the polar view's three maps), in
bf16 and f32, it compares the two trees' ``grid_sample_2d_quad_kernel``
outputs with ``torch.equal``, and each map's gradient under one cotangent
from seed 7. It times, in turns (parent, this tree, this tree, parent),
each tree's kernel alone (``chip_smoke.graph_ms``, launches replayed from a
CUDA graph, and ``calls_ms``, its calls back to back as the host launches
them; the parent's kernel on the padded map and ``quad_indices``' idx/w4
made beforehand) and each route (the autograd entry under ``no_grad`` and
with the map requiring grad, back to back). Then it serves the flagship
polar frame (``vod_polar_config``, bf16, weights from seed 0) from each
tree in the same turns through this tree's
``profile_serve.profile_frames``, with the peak device memory of those
frames. Exits non-zero when an output or a gradient differs.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

import chip_smoke as cs
import hgsfusion_tpu_torch
from hgsfusion_tpu_torch.ops import library
from hgsfusion_tpu_torch.profile_serve import profile_frames


def load_tree(root: Path, alias: str):
    """The package ``hgsfusion_tpu_torch`` of the tree at ``root``,
    imported as ``alias``."""
    pkg = root / "hgsfusion_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


def route_cases(dev):
    """(name, map, coords) of the five maps, inputs as described above."""
    uv = cs.flagship_grid(dev)[..., 0:2]
    polar = cs.polar_coords(dev)
    g = torch.Generator().manual_seed(1)
    cases = [(name, torch.randn(shape, generator=g).to(dev), uv)
             for name, shape in cs.FLAGSHIP_SHAPES.items()]
    g = torch.Generator().manual_seed(3)
    cases += [(name, torch.randn(shape, generator=g).to(dev), polar[name])
              for name, shape in cs.POLAR_SHAPES.items()]
    return cases


def kernel_call(label, qs, f, coords):
    """A call of ``label``'s kernel alone on map ``f`` and ``coords``."""
    if label == "change":
        return lambda: library.quad_sample_fwd(f, coords)
    idx, w4 = qs.quad_indices(f, coords)
    fp = F.pad(f, (0, 0, 1, 1, 1, 1)).contiguous()
    return lambda: qs.quad_sample_fwd(fp, idx, w4)


def compare_routes(dev, trees):
    rows, ok = [], True
    for name, feats, coords in route_cases(dev):
        for dtype in (torch.bfloat16, torch.float32):
            f = feats.to(dtype)
            results = {}
            for label, qs in trees.items():
                fg = f.detach().clone().requires_grad_()
                out = qs.grid_sample_2d_quad_kernel(fg, coords)
                cot = torch.randn(out.shape, device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(7)).to(dtype)
                (grad,) = torch.autograd.grad(out, fg, cot)
                results[label] = (out.detach(), grad)
                del fg, out, cot
            row = {"case": name, "dtype": str(dtype).replace("torch.", ""),
                   "shape": list(f.shape), "queries": coords[..., 0].numel(),
                   "output_equal": bool(torch.equal(results["parent"][0], results["change"][0])),
                   "grad_equal": bool(torch.equal(results["parent"][1], results["change"][1]))}
            del results
            ok = ok and row["output_equal"] and row["grad_equal"]
            fg = f.detach().requires_grad_()
            for label in ("parent", "change", "change", "parent"):
                qs = trees[label]
                kernel = kernel_call(label, qs, f, coords)
                row.setdefault(f"{label}_ms", []).append(cs.graph_ms(kernel))
                row.setdefault(f"{label}_calls_ms", []).append(cs.cuda_ms(kernel, iters=50))
                del kernel
                with torch.no_grad():
                    ms = cs.cuda_ms(lambda: qs.grid_sample_2d_quad_kernel(f, coords))
                row.setdefault(f"{label}_route_ms", []).append(ms)
                ms = cs.cuda_ms(lambda: qs.grid_sample_2d_quad_kernel(fg, coords))
                row.setdefault(f"{label}_route_grad_ms", []).append(ms)
            print("  " + json.dumps(row), flush=True)
            rows.append(row)
            torch.cuda.empty_cache()
    return rows, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, help="the other tree's root")
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_fwd_parent: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    parent = load_tree(args.parent.resolve(), "parent_tree")
    pkgs = {"parent": parent, "change": hgsfusion_tpu_torch}
    trees = {label: importlib.import_module(f"{p.__name__}.ops.quad_sample")
             for label, p in pkgs.items()}
    print("[routes]", flush=True)
    rows, ok = compare_routes(dev, trees)
    print("[serve_polar]", flush=True)
    serve = []
    for label in ("parent", "change", "change", "parent"):
        pkg = pkgs[label].__name__
        cfg = importlib.import_module(f"{pkg}.config").vod_polar_config()
        model = importlib.import_module(f"{pkg}.models.detector").HGSFusionModel(
            cfg, device=dev, seed=0)
        batch = importlib.import_module(f"{pkg}.synthetic").flagship_batch(cfg)
        torch.cuda.reset_peak_memory_stats(dev)
        r = {"tree": label, **profile_frames(model, batch, frames=3),
             "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
        del model
        print("  " + json.dumps(r), flush=True)
        serve.append(r)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": cs.card_line(), "routes": rows, "serve_polar": serve}, f, indent=1)
    print(json.dumps({"all_equal": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
