#!/usr/bin/env python3
"""Time edited copies of the farthest-point sampling kernel on one NVIDIA GPU.

    python3 tune_fps.py ['{"name": {"a snippet of the source": "its replacement",
                                    "block_points": 2048}, ...}']

Each variant is ``hgsfusion_tpu_torch/csrc/fps.cu`` with each snippet (which
must occur exactly once; an identifier names a ``constexpr int`` constant and
takes a value instead) replaced, built with ``nvcc`` into ``_build/tune/``
under the package, all at once, with its kernels' ptxas lines printed. The
key ``block_points`` and the constant ``THREADS`` also go to
``library.fps_plan`` for that variant's cluster size and points a thread. Three variants are always built and timed:

- ``chain_floor`` (``CHAIN_FLOOR``): each point's distance is the last
  point's x instead of its eight rounded operations, so a step is the
  running minimum, the thread's best, the warp and cluster reductions, the
  barrier and the exchange: what the chain alone costs;
- ``block_records`` (``BLOCK_RECORDS``): a block's warps reduce to one
  record a block (a block barrier and one more reduction) before the
  cluster exchange, C records a step instead of C x 8;
- ``cluster_barrier`` (``CLUSTER_BARRIER``): the records stored into the
  other blocks' slots by plain ``st.shared::cluster`` and one cluster
  barrier a step (arrive.release / wait.acquire) in place of ``st.async``
  counted on each block's ``mbarrier``; the indices written 32 at a time,
  since a release orders the thread's earlier global stores before it.

A fourth, ``sm_probe`` (``SM_PROBE``), writes block r's SM (``%smid``) as
the index of step r + 1: the number of distinct SMs a frame's cluster ran
on is printed per case (``sms``), not timed.

At ``chip_smoke.py``'s timed FPS cases (8,192 points at B=1 and B=2, 16,384,
the proposal-centric mask), and at the proposal-centric frame compacted to
its valid points in order (what a compaction ahead of the chain would buy,
the compaction's own cost left out), it prints the committed kernel's and
each variant's device time (``chip_smoke.graph_ms``, two passes, the second
in reverse order), their cluster sizes and points a thread, and whether each
variant's indices equal the committed kernel's (the chain floor's are not
compared). Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys

import torch

import chip_smoke as cs
from hgsfusion_tpu_torch.ops import library, pointnet2
from tune_quad_bwd import build

CHAIN_FLOOR = {"""      const float dx = __fsub_rn(x[q], lx), dy = __fsub_rn(y[q], ly), dz = __fsub_rn(z[q], lz);
      const float dd =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));""":
               "      const float dd = lx;"}
BLOCK_RECORDS = {
    "const int records = c * WARPS;": "const int records = c;",
    """    if (lane < c)
      publish(s_key[par], s_rec[par], &s_bar[par], static_cast<int>(rank) * WARPS + warp, lane,
              wkey, widx, s_pt[widx != kNone ? widx - base : 0]);""": """    __shared__ unsigned s_wkey[2][WARPS], s_widx[2][WARPS];
    if (lane == 0) {
      s_wkey[par][warp] = wkey;
      s_widx[par][warp] = widx;
    }
    __syncthreads();
    if (warp == 0) {
      const unsigned kw = lane < WARPS ? s_wkey[par][lane] : 0u;
      const unsigned iw = lane < WARPS ? s_widx[par][lane] : kNone;
      const unsigned bkey = __reduce_max_sync(kFull, kw);
      const unsigned bidx = __reduce_min_sync(kFull, kw == bkey ? iw : kNone);
      if (lane < c)
        publish(s_key[par], s_rec[par], &s_bar[par], static_cast<int>(rank), lane, bkey, bidx,
                s_pt[bidx != kNone ? bidx - base : 0]);
    }"""}
CLUSTER_BARRIER = {
    "    if (t == 0) expect_bytes(&s_bar[par], records * RECORD_BYTES);\n": "",
    "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];":
        "st.shared::cluster.b32 [%0], %1;",
    '"st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "\n'
    '      "[%5];"': '"st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};"',
    "    wait_parity(&s_bar[par], ((s - 1) >> 1) & 1);":
        '    asm volatile("barrier.cluster.arrive;\\n\\tbarrier.cluster.wait;" ::: "memory");',
    "const int records = c * WARPS;": "const int records = c * WARPS;\n  unsigned mine = 0;",
    "    if (rank == 0 && t == THREADS - 1) o[s] = rec.x;": """    if (rank == 0 && warp == 0) {
      if (lane == (s & 31)) mine = rec.x;
      if (((s & 31) == 31 || s == k - 1) && lane <= (s & 31)) o[(s & ~31) + lane] = mine;
    }"""}
SM_PROBE = {"    if (rank == 0 && t == THREADS - 1) o[s] = rec.x;": """    if (t == THREADS - 1 && s == static_cast<int>(rank) + 1) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      o[s] = sm;
    }"""}
PLAN_KEYS = {"block_points": "block_points", "THREADS": "threads"}
TIMED = ("flagship", "flagship_b2", "points_16k", "proposal_centric")


def split(variants: dict) -> tuple[dict, dict]:
    """({name: source edits}, {name: ``fps_plan`` keyword arguments})."""
    edits, plans = {}, {}
    for name, knobs in variants.items():
        edits[name] = {k: v for k, v in knobs.items() if k != "block_points"}
        plans[name] = {PLAN_KEYS[k]: int(v) for k, v in knobs.items() if k in PLAN_KEYS}
    return edits, plans


def build_variants(variants: dict) -> tuple[dict, dict]:
    """({name: the variant's C entry ``fps``}, {name: its plan arguments})."""
    edits, plans = split(variants)
    return build(edits, "fps", library.FPS, "fps_kernel"), plans


def launch(fn, xyz, valid, k: int, **plan):
    """One launch of a variant's C entry, as ``library.farthest_point_sample``."""
    b, n = valid.shape
    cluster, pts = library.fps_plan(n, **plan)
    out = torch.empty((b, k), dtype=torch.int64, device=xyz.device)
    err = fn(xyz.data_ptr(), valid.data_ptr(), b, n, k, cluster, pts, out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cudaError {err}")
    return out


def chain_floor():
    """The chain floor's C entry (``CHAIN_FLOOR``), built once."""
    return build_variants({"chain_floor": CHAIN_FLOOR})[0]["chain_floor"]


def compacted(xyz, valid):
    """The valid points of a one-frame case, in order, as a frame of their own."""
    keep = valid[0].nonzero()[:, 0]
    sub = xyz[:, keep].contiguous()
    return sub, torch.ones(sub.shape[:2], dtype=torch.bool, device=xyz.device)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("tune_fps: no CUDA device", file=sys.stderr)
        return 2
    variants = {"chain_floor": CHAIN_FLOOR, "block_records": BLOCK_RECORDS,
                "cluster_barrier": CLUSTER_BARRIER, "sm_probe": SM_PROBE,
                **(json.loads(argv[0]) if argv else {})}
    fns, plans = build_variants(variants)
    probe = fns.pop("sm_probe")
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    cases = {case: cs.fps_inputs(case, dev) for case in TIMED}
    cases["proposal_compacted"] = compacted(*cases["proposal_centric"])
    k = cs.FPS_K
    for case, (xyz, valid) in cases.items():
        ops = {"committed": lambda: pointnet2.farthest_point_sample(xyz, valid, k)}
        ops.update({name: (lambda f=f, p=plans[name]: launch(f, xyz, valid, k, **p))
                    for name, f in fns.items()})
        ref = ops["committed"]()
        n = valid.shape[1]
        cluster = library.fps_plan(n)[0]
        sms = launch(probe, xyz, valid, k)[:, 1:cluster + 1]
        row = {"case": case, "batch": valid.shape[0], "points": n, "valid": int(valid.sum()),
               "sms": [len(set(f.tolist())) for f in sms],
               "plan": {name: library.fps_plan(n, **plans.get(name, {})) for name in ops},
               "equal": {name: bool(torch.equal(op(), ref)) for name, op in ops.items()
                         if name not in ("committed", "chain_floor")},
               "ms": {}}
        for order in (list(ops), list(ops)[::-1]):
            for name in order:
                row["ms"].setdefault(name, []).append(cs.graph_ms(ops[name], iters=5,
                                                                  replays=2))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
