"""A serving host: run an artifact of ``tools/export.py`` on ``.npz``
batches, with no model code (counterpart of the JAX package's
``tools/serve.py``).

    python -m hgsfusion_tpu_torch.tools.serve --artifact model.pt2 --inputs batches/ \\
        [--out_dir detections] [--warmup 1] [--time]

It imports ``torch`` and ``ops/library.py`` (which registers the kernels'
ops the graph calls, as the TPU runtime brings Mosaic) and nothing of the
model code: no config parsing, no checkpoint restore, no
``hgsfusion_tpu_torch.models``. Each ``.npz`` holds one batch, an array per
input key at the shapes and dtypes the artifact pins (its ``inputs.json``);
the detections go to ``<out_dir>/<stem>_dets.npz`` (``boxes``, ``scores``,
``labels``, ``valid``, fixed shapes). The artifact runs on the device it was
exported on; a CUDA artifact on a host without CUDA raises.

Batch i + 1 is dispatched before batch i's detections are fetched, so the
copy and the device's work overlap the host's fetch and save; ``--time``
prints the gaps between completions (a span per batch would bill the next
file's read to this one). The last line is a JSON summary: frames, the
mean gap, the kernel launches of the timed batches (``library.launches``).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import library

SPEC_FILE = "inputs.json"  # tools/export.py's record of the inputs
OUTPUT_KEYS = ("boxes", "scores", "labels", "valid")


def load_artifact(path):
    """-> (the artifact's module, its input spec {"device", "inputs": {key:
    {"shape", "dtype"}}})."""
    extra = {SPEC_FILE: ""}
    program = torch.export.load(str(path), extra_files=extra)
    spec = json.loads(extra[SPEC_FILE])
    if spec["device"] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for CUDA and no CUDA device is available")
    return program.module(), spec


def batch_inputs(data, spec) -> dict:
    """The artifact's inputs from one ``.npz``, checked against its pinned
    shapes and dtypes, on its device."""
    device = torch.device(spec["device"])
    out = {}
    for key, want in spec["inputs"].items():
        if key not in data:
            raise ValueError(f"input {key} missing")
        a = np.asarray(data[key])
        if list(a.shape) != want["shape"] or str(a.dtype) != want["dtype"]:
            raise ValueError(f"input {key}: {a.dtype}{list(a.shape)}, the artifact pins "
                             f"{want['dtype']}{want['shape']}")
        out[key] = torch.from_numpy(a).to(device, non_blocking=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--artifact", required=True, help=".pt2 file of tools/export.py")
    p.add_argument("--inputs", required=True, help="directory of .npz batches (or one .npz)")
    p.add_argument("--out_dir", default="detections")
    p.add_argument("--warmup", type=int, default=1,
                   help="calls on the first batch before the timed ones")
    p.add_argument("--time", action="store_true", help="print the gap between completions")
    args = p.parse_args(argv)

    module, spec = load_artifact(args.artifact)
    print(f"loaded {args.artifact}: {spec['device']}, inputs {sorted(spec['inputs'])}")
    inputs = Path(args.inputs)
    files = sorted(inputs.glob("*.npz")) if inputs.is_dir() else [inputs]
    if not files:
        raise SystemExit(f"no .npz batches under {inputs}")
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def call(path):
        with np.load(path) as data:
            batch = batch_inputs(data, spec)
        with torch.inference_mode():
            return module(batch)  # the device's work is queued, not waited for

    for _ in range(max(args.warmup, 0)):
        {k: v.cpu() for k, v in call(files[0]).items()}
    for k in library.launches:
        library.launches[k] = 0
    gaps, last_done = [], None

    def finish(path, dets):
        nonlocal last_done
        dets = {k: dets[k].cpu().numpy() for k in OUTPUT_KEYS}  # waits for the device
        now = time.perf_counter()
        out = out_dir / f"{path.stem}_dets.npz"
        np.savez(out, **dets)
        msg = f"{path.name} -> {out.name}"
        if last_done is not None:
            gaps.append((now - last_done) * 1e3)
            if args.time:
                msg += f"  {gaps[-1]:.1f} ms"
        last_done = now
        print(msg)

    pending = None
    for path in files:
        dets = call(path)
        if pending is not None:
            finish(*pending)
        pending = (path, dets)
    finish(*pending)
    summary = {"frames": len(files), "ms_per_frame": float(np.mean(gaps)) if gaps else None,
               "gaps_ms": gaps, "launches": dict(library.launches), "device": spec["device"]}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
