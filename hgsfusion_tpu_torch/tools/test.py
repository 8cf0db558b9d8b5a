"""Evaluation CLI: a model over the val split, KITTI-format annotations,
recall and the official AP (counterpart of the JAX package's
``tools/test.py``).

    python -m hgsfusion_tpu_torch.tools.test --cfg_file configs/hgsfusion_vod.yaml \\
        [--ckpt model.pth | --ckpt_dir <out>/ckpt [--ckpt_step N | --eval_all]] \\
        [--device cuda] [--batch_size 1] [--max_frames N] [--save_to_file] \\
        [--infer_time] [--set DATA_CONFIG.DATA_PATH <root> ...]
    torchrun --nproc_per_node N -m hgsfusion_tpu_torch.tools.test ...

``--ckpt_dir`` reads the checkpoints of ``tools/train.py``: the newest step,
or ``--ckpt_step``; ``--eval_all`` evaluates every step not yet evaluated
and polls the directory for new ones until ``--max_waiting_mins`` pass
without one.

``run_eval`` pipelines three threads: a producer builds and collates the
next batches and copies them to the device, the main thread dispatches
``HGSFusionModel.serve``, and a finisher reads the detections back and runs
the host post-processing (recall, then the KITTI annotations). The
per-frame results are those of serving the batches one by one; the
pipeline only overlaps the work. Under ``torchrun`` each process serves a
strided shard of the frames on its own card and its own threads
(``parallel/multihost.py``); the annotations are merged back into frame
order and the recall counts summed before the official evaluation, which
every rank computes; rank 0 logs and writes ``result.pkl``.
"""
from __future__ import annotations

import argparse
import json
import pickle
import queue
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..config import cfg_from_list, load_config, model_config_from_yaml
from ..datasets import build_dataset
from ..eval.rotated_iou_np import rotate_iou_eval
from ..models.detector import resolve_device
from ..models.registry import build_network
from ..ops import library
from ..parallel.mesh import init_distributed, shutdown
from ..parallel.multihost import (allreduce_host_scalars, is_padding,
                                  merge_anno_lists_across_hosts, process_group,
                                  shard_indices_for_host)
from ..train.checkpoint import CheckpointManager, load_checkpoint
from ..train.trainer import detections_to_pred_dicts
from ..utils.common import create_logger


def recall_iou3d(gt_lidar, pred_lidar):
    """(N, 7) x (M, 7) lidar boxes -> (N, M) rotated 3D IoU, f64: the BEV
    overlap (x, y, dx, dy, heading) times the z slab."""
    inter_bev = rotate_iou_eval(gt_lidar[:, [0, 1, 3, 4, 6]], pred_lidar[:, [0, 1, 3, 4, 6]], 2)
    top = np.minimum(gt_lidar[:, None, 2] + gt_lidar[:, None, 5] / 2,
                     pred_lidar[None, :, 2] + pred_lidar[None, :, 5] / 2)
    bot = np.maximum(gt_lidar[:, None, 2] - gt_lidar[:, None, 5] / 2,
                     pred_lidar[None, :, 2] - pred_lidar[None, :, 5] / 2)
    inter = inter_bev * np.clip(top - bot, 0, None)
    vol_a = np.prod(gt_lidar[:, 3:6], axis=1)[:, None]
    vol_b = np.prod(pred_lidar[:, 3:6], axis=1)[None, :]
    return inter / np.clip(vol_a + vol_b - inter, 1e-6, None)


def batch_to_device(model, batch, stream):
    """The model's keys of a collated batch on its device, and the (start,
    end) events that bracket the copies (None on the CPU). On CUDA the
    copies run on ``stream``, the uint8 image from pinned memory without
    blocking the host; the caller orders its stream after ``end``."""
    if model.device.type != "cuda":
        return model.batch_to_device(batch), None
    host = dict(batch)
    if "images" in host:
        host["images"] = torch.from_numpy(host["images"]).pin_memory()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(stream):
        start.record(stream)
        if "images" in host:
            host["images"] = host["images"].to(model.device, non_blocking=True)
        dev = model.batch_to_device(host)
        end.record(stream)
    return dev, (start, end)


def run_eval(cfg, model, dataset, logger, batch_size=1, infer_time=False,
             max_frames=None, result_dir=None):
    """Serve ``dataset``'s frames through ``model`` and evaluate them.

    ``cfg`` holds ``MODEL.POST_PROCESSING`` (RECALL_THRESH_LIST, EVAL_METRIC).
    Returns (det_annos, result_dict, stats). ``stats``: frames, the
    pipelined ms per frame (the mean gap between completions, first two
    batches dropped), the host ms per frame of each stage (getitem, collate,
    h2d, finish), the copies' device ms per frame (h2d_device), the kernel
    launch counts of each batch, the recall counts and the evaluation's
    seconds. In a process group of more than one rank, this rank serves
    its shard (``shard_indices_for_host``) and every rank returns the
    merged annotations and recall counts of all frames (a wrap-padding
    duplicate of the last shards counts once); the timings and launches are
    this rank's.
    """
    post = cfg["MODEL"]["POST_PROCESSING"]
    recall_thresh = list(post["RECALL_THRESH_LIST"])
    recall = {t: 0 for t in recall_thresh}
    total_gt = 0
    n = len(dataset) if max_frames is None else min(max_frames, len(dataset))
    frame_idxs = shard_indices_for_host(n)
    padding = is_padding(n, *process_group())
    det_annos = []
    host_s = {"getitem": 0.0, "collate": 0.0, "h2d": 0.0, "finish": 0.0}
    copy_events = []
    launches_per_batch = []
    copy_stream = torch.cuda.Stream(model.device) if model.device.type == "cuda" else None

    def host_post(out, batch, pad):
        nonlocal total_gt
        pred_dicts = detections_to_pred_dicts(out)
        gt = batch["gt_boxes"]
        for bi, pd in enumerate(pred_dicts):
            if pad[bi]:
                continue
            gt_i = gt[bi][gt[bi][:, -1] > 0]
            total_gt += len(gt_i)
            if len(gt_i) and len(pd["pred_boxes"]):
                iou = recall_iou3d(np.asarray(gt_i[:, :7], np.float64),
                                   np.asarray(pd["pred_boxes"][:, :7], np.float64))
                best = iou.max(axis=1)
                for t in recall_thresh:
                    recall[t] += int((best > t).sum())
        return dataset.generate_prediction_dicts(batch, pred_dicts, dataset.class_names,
                                                 output_path=result_dir)

    batch_q: queue.Queue = queue.Queue(maxsize=3)
    finish_q: queue.Queue = queue.Queue(maxsize=3)
    finish_err: list = []
    # set on every exit of the dispatch loop, so the producer never stays
    # blocked on a full queue
    stop_evt = threading.Event()

    def put(item) -> bool:
        while not stop_evt.is_set():
            try:
                batch_q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for i0 in range(0, len(frame_idxs), batch_size):
                if stop_evt.is_set():
                    return
                idxs = frame_idxs[i0:i0 + batch_size]
                t0 = time.perf_counter()
                samples = [dataset[j] for j in idxs]
                t1 = time.perf_counter()
                batch = dataset.collate_batch(samples)
                t2 = time.perf_counter()
                dev, copy = batch_to_device(model, batch, copy_stream)
                if copy is not None:
                    copy_events.append(copy)
                t3 = time.perf_counter()
                host_s["getitem"] += t1 - t0
                host_s["collate"] += t2 - t1
                host_s["h2d"] += t3 - t2
                if not put((padding[i0:i0 + batch_size], batch, dev, copy)):
                    return
            put(None)
        except BaseException as exc:  # re-raised on the main thread
            put(exc)

    # pipelined time: the gaps between completions tile the wall clock
    times = []
    last_done = None

    def finisher():
        nonlocal last_done
        while True:
            item = finish_q.get()
            if item is None:
                return
            if finish_err:
                continue  # drain without work after a failure
            try:
                out, batch, pad = item
                n_frames = len(pad)
                t0 = time.perf_counter()
                det_annos.extend(host_post(out, batch, pad))
                now = time.perf_counter()
                host_s["finish"] += now - t0
                if last_done is not None:
                    times.append((now - last_done) / n_frames)
                last_done = now
            except BaseException as exc:  # re-raised on the main thread
                finish_err.append(exc)

    prod_thread = threading.Thread(target=producer, daemon=True)
    fin_thread = threading.Thread(target=finisher, daemon=True)
    prod_thread.start()
    fin_thread.start()
    done = 0
    producer_exc = None
    try:
        while True:
            item = batch_q.get()
            if isinstance(item, BaseException):
                producer_exc = item
                break
            if item is None or finish_err:
                break
            pad, batch, dev, copy = item
            if copy is not None:
                stream = torch.cuda.current_stream(model.device)
                stream.wait_event(copy[1])
                for v in dev.values():  # allocated on the copy stream
                    v.record_stream(stream)
            before = dict(library.launches)
            out = model.serve(dev)
            launches_per_batch.append({k: library.launches[k] - before[k] for k in before})
            finish_q.put((out, batch, pad))
            done += 1
            if done % 50 == 1:
                logger.info(f"eval {done * batch_size}/{len(frame_idxs)}")
    finally:
        stop_evt.set()
        while prod_thread.is_alive():
            try:
                batch_q.get_nowait()
            except queue.Empty:
                prod_thread.join(timeout=0.1)
        finish_q.put(None)
        fin_thread.join()
    if producer_exc is not None:
        raise producer_exc
    if finish_err:
        raise finish_err[0]

    served = len(det_annos)
    det_annos = merge_anno_lists_across_hosts(det_annos, n)
    summed = allreduce_host_scalars({**{f"recall@{t}": recall[t] for t in recall_thresh},
                                     "total_gt": total_gt})
    total_gt = int(summed["total_gt"])
    recall = {t: int(summed[f"recall@{t}"]) for t in recall_thresh}

    logger.info("kernel launches: " + json.dumps(
        {k: sum(b[k] for b in launches_per_batch) for k in library.launches}))
    steady = times[2:] or times
    ms_per_frame = float(np.mean(steady)) * 1e3 if steady else float("nan")
    if infer_time and steady:
        logger.info(f"inference (pipelined): {ms_per_frame:.1f} ms/frame "
                    f"({1e3 / ms_per_frame:.2f} FPS)")
    for t in recall_thresh:
        logger.info(f"recall@{t}: {recall[t] / max(total_gt, 1):.4f} ({recall[t]}/{total_gt})")
    # --max_frames shortens the loop; the evaluator compares the detections
    # with the dataset's info list, so trim it to match
    if len(dataset.infos) > len(det_annos):
        dataset.infos = dataset.infos[: len(det_annos)]

    eval_kwargs = {}
    if post.get("EVAL_METRIC"):
        eval_kwargs["eval_metric"] = post["EVAL_METRIC"]
    if result_dir:
        eval_kwargs["output_path"] = result_dir
    t0 = time.perf_counter()
    result_str, result_dict = dataset.evaluation(det_annos, dataset.class_names, **eval_kwargs)
    eval_s = time.perf_counter() - t0
    logger.info("\n" + result_str)
    if copy_events:
        torch.cuda.synchronize(model.device)
    stats = {
        "frames": len(det_annos), "frames_served": served, "ms_per_frame": ms_per_frame,
        "host_ms_per_frame": {k: v * 1e3 / max(n, 1) for k, v in host_s.items()},
        "h2d_device_ms_per_frame": (sum(s.elapsed_time(e) for s, e in copy_events) / max(n, 1)
                                    if copy_events else None),
        "launches_per_batch": launches_per_batch,
        "recall": recall, "total_gt": total_gt, "eval_s": eval_s,
    }
    return det_annos, result_dict, stats


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--ckpt", default=None,
                   help="a .pth file: this package's state_dict or a pcdet {'model_state': ...}")
    p.add_argument("--ckpt_dir", default=None,
                   help="a checkpoint directory of tools/train.py (its newest step)")
    p.add_argument("--ckpt_step", type=int, default=None, help="the step to read from --ckpt_dir")
    p.add_argument("--eval_all", action="store_true",
                   help="evaluate every step in --ckpt_dir, polling for new ones")
    p.add_argument("--max_waiting_mins", type=float, default=30.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0, help="the random weights' seed without --ckpt")
    p.add_argument("--extra_tag", default="default")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--infer_time", action="store_true")
    p.add_argument("--save_to_file", action="store_true")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.eval_all and not args.ckpt_dir:
        raise SystemExit("--eval_all requires --ckpt_dir (otherwise only the randomly "
                         "initialized model would be evaluated)")
    ctx = init_distributed(args.device)
    try:
        return _evaluate(args, ctx)
    finally:
        shutdown(ctx)


def _rank0(ctx, value):
    """Rank 0's ``value`` on every rank (the value itself for one process)."""
    if ctx.world_size == 1:
        return value
    box = [value]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


def _evaluate(args, ctx):
    device = ctx.device if ctx.active else resolve_device(args.device)
    cfg = load_config(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(cfg, args.set_cfgs)
    model_cfg = model_config_from_yaml(cfg)

    out_dir = Path(args.output_dir) / cfg["TAG"] / args.extra_tag / "eval"
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(out_dir / "eval.log", rank=ctx.rank)
    dataset = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False,
                            logger=logger)
    model = build_network(cfg, model_cfg, device=device, seed=args.seed)

    def eval_once(tag=""):
        result_dir = out_dir / f"final_result{tag}" if args.save_to_file else None
        if result_dir:
            result_dir.mkdir(parents=True, exist_ok=True)
        det_annos, result_dict, stats = run_eval(
            cfg, model, dataset, logger, batch_size=args.batch_size,
            infer_time=args.infer_time, max_frames=args.max_frames, result_dir=result_dir)
        if ctx.is_main:
            with open(out_dir / f"result{tag}.pkl", "wb") as f:
                pickle.dump(det_annos, f)
            logger.info(f"results saved to {out_dir}")
        return result_dict, stats

    results = {}
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, log=logger)

        def eval_step(step, tag=""):
            load_checkpoint(model, ckpt.path(step), logger)
            logger.info(f"loaded checkpoint step {step}")
            results[step] = eval_once(tag)

        if args.eval_all:
            # the first sweep always runs (0 minutes: evaluate what is there);
            # then poll until no new step appears for max_waiting_mins
            budget = args.max_waiting_mins * 60
            poll_s = max(min(30.0, budget), 0.5)
            waited = 0.0
            while True:
                # rank 0's listing, so that every rank evaluates the same steps
                steps = _rank0(ctx, [s for s in ckpt.all_steps() if s not in results])
                if not steps:
                    if waited >= budget:
                        break
                    time.sleep(poll_s)
                    waited += poll_s
                    continue
                waited = 0.0
                for step in steps:
                    eval_step(step, tag=f"_step{step}")
            logger.info(f"evaluated checkpoints: {sorted(results)}")
        else:
            step = _rank0(ctx, args.ckpt_step if args.ckpt_step is not None
                          else ckpt.latest_step())
            if step is None:
                raise SystemExit(f"no checkpoint in {args.ckpt_dir}")
            eval_step(step)
    else:
        if args.ckpt:
            load_checkpoint(model, args.ckpt, logger)
            logger.info(f"loaded {args.ckpt}")
        else:
            logger.warning(f"no --ckpt: evaluating random weights from seed {args.seed}")
        results[None] = eval_once()
    return results


if __name__ == "__main__":
    main()
