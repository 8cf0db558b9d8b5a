"""Training CLI (counterpart of the JAX package's ``tools/train.py``, its
HGSFusion, radar-only, PointPillar, TransFusion-head (BEVFusion,
TransFusion-L), CenterHead (CenterPoint, VoxelNeXt) and SECOND branches).

    python -m hgsfusion_tpu_torch.tools.train --cfg_file configs/hgsfusion_vod.yaml \\
        [--set DATA_CONFIG.DATA_PATH <root> ...] [--device cuda] [--epochs N] \\
        [--max_steps N] [--workers 4] [--ckpt <file.pth> | --ckpt <step>] \\
        [--profile_steps START:END] [--fix_random_seed]
    torchrun --nproc_per_node N -m hgsfusion_tpu_torch.tools.train --cfg_file ...

Augmented training frames come from a threaded loader (``datasets/loader.py``)
and go through one training step each (``train/trainer.py``); weights are
drawn from a seed. Under ``torchrun`` each process trains on its own card
(``cuda:LOCAL_RANK``) under ``DistributedDataParallel``
(``parallel/mesh.py``), as the JAX CLI trains over its data mesh: the batch
is ``BATCH_SIZE_PER_DEVICE`` (or ``--batch_size``) per process, the global
batch that times the world size, and the steps per epoch and the OneCycle
length come from the global batch; the BatchNorms take their statistics
over the global batch. Every rank builds the same index schedule and takes
its slice of each global batch. The loss is read back to the host every 50
steps and at the last step. A checkpoint (``train/checkpoint.py``) is
written by rank 0 to ``<output_dir>/<TAG>/<extra_tag>/ckpt`` at each epoch
boundary, every ``--ckpt_save_interval_s`` and at the end, and a new run
resumes from the newest one that loads (every rank from the same file).
``--ckpt <file>`` starts from a file's weights with a fresh optimizer;
``--ckpt <step>`` resumes from that step. Rank 0 logs. The model family
comes from ``MODEL.NAME`` through ``models/registry.py::build_network``,
its step from ``train/trainer.py::make_train_step_for_cfg``; a family the
port does not build raises there (ROADMAP.md queue 1 item 9).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..config import cfg_from_list, load_config, model_config_from_yaml
from ..datasets import build_dataset
from ..datasets.loader import PrefetchLoader
from ..models.detector import BATCH_KEYS, Detector, resolve_device
from ..models.registry import build_network, yaml_network_class
from ..ops import library
from ..parallel.mesh import DistContext, init_distributed, shutdown, wrap_model
from ..train.checkpoint import CheckpointManager, load_checkpoint
from ..train.optim import build_optimizer
from ..train.trainer import make_train_step_for_cfg
from ..utils.common import create_logger

WEIGHT_SEED = 0  # the random weights of a run that loads none
LOG_EVERY = 50


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--extra_tag", default="default")
    p.add_argument("--ckpt", default=None,
                   help="a .pth file to start from (fresh optimizer), or a step of ckpt/ "
                        "to resume")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--max_ckpt_save_num", type=int, default=30)
    p.add_argument("--fix_random_seed", action="store_true")
    p.add_argument("--merge_all_iters_to_one_epoch", action="store_true",
                   help="fold all epochs into one long epoch")
    p.add_argument("--workers", type=int, default=4,
                   help="sample-building threads (0: synchronous)")
    p.add_argument("--max_steps", type=int, default=None, help="cap the steps of this run")
    p.add_argument("--profile_steps", default=None,
                   help="START:END steps to trace with torch.profiler into <out>/profile")
    p.add_argument("--disable_aug_last_epochs", type=int, default=0,
                   help="drop the hook's DISABLE_AUG_LIST augmentations for the last N epochs")
    p.add_argument("--ckpt_save_interval_s", type=float, default=300.0,
                   help="seconds between checkpoints within an epoch")
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


@dataclasses.dataclass
class Run:
    """A training run as ``prepare`` leaves it, before its first step."""
    args: Any
    cfg: dict
    logger: Any
    out_dir: Path
    device: torch.device
    dataset: Any
    loader: PrefetchLoader
    model: Detector
    optimizer: Any
    lr_schedule: Any
    train_step: Any
    ckpt: CheckpointManager
    steps_per_epoch: int
    epochs: int
    total_steps: int
    start_step: int
    resumed_from: Optional[int]
    resume_s: float
    tb: Any
    dist: DistContext


def prepare(args) -> Run:
    """Config, dataset, loader, model, optimizer and checkpoints; restores
    the newest checkpoint of the run's directory."""
    cfg = load_config(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(cfg, args.set_cfgs)
    yaml_network_class(cfg)  # an unported MODEL.NAME raises before anything starts
    ctx = init_distributed(args.device)
    device = ctx.device if ctx.active else resolve_device(args.device)
    model_cfg = model_config_from_yaml(cfg)
    out_dir = Path(args.output_dir) / cfg["TAG"] / args.extra_tag
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(out_dir / "train.log", rank=ctx.rank)
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
                + (f", rank {ctx.rank} of {ctx.world_size} ({ctx.backend})" if ctx.active
                   else ""))
    tb = None
    if ctx.is_main:
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            pass
        else:
            tb = SummaryWriter(str(out_dir / "tensorboard"))
    if args.fix_random_seed:
        np.random.seed(666)

    opt_cfg = cfg["OPTIMIZATION"]
    per_rank = args.batch_size or int(opt_cfg.get("BATCH_SIZE_PER_DEVICE", 1))
    batch_size = per_rank * ctx.world_size
    epochs = args.epochs or int(opt_cfg["NUM_EPOCHS"])
    dataset = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=True,
                            logger=logger)
    if args.merge_all_iters_to_one_epoch:
        dataset._merge_all_iters_to_one_epoch = True
        dataset.total_epochs = epochs
        epochs = 1
    if len(dataset) == 0:
        raise SystemExit(
            "dataset is empty — generate info files first: python -m "
            f"hgsfusion_tpu_torch.tools.create_infos --cfg_file {args.cfg_file}")
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    total_steps = steps_per_epoch * epochs
    logger.info(f"dataset {len(dataset)} frames, batch {batch_size}"
                + (f" ({per_rank} per rank)" if ctx.world_size > 1 else "")
                + f", {steps_per_epoch} steps/epoch, {total_steps} total")

    model = build_network(cfg, model_cfg, device=device, seed=WEIGHT_SEED)
    optimizer, lr_schedule = build_optimizer(model_cfg.optimization, total_steps, model)
    schedule_seed = None  # the loader draws its own from np.random
    if ctx.active:
        # the draw the loader would make, rank 0's on every rank; under
        # --fix_random_seed the other ranks then take augmentation streams
        # of their own
        seeds = [int(np.random.randint(0, 2**31))]
        torch.distributed.broadcast_object_list(seeds, src=0)
        schedule_seed = seeds[0]
        if args.fix_random_seed and ctx.rank:
            np.random.seed(666 + ctx.rank)
    loader = PrefetchLoader(dataset, per_rank, shuffle=True, num_workers=args.workers,
                            prefetch=2, pin_keys=BATCH_KEYS if device.type == "cuda" else (),
                            rank=ctx.rank, world_size=ctx.world_size, seed=schedule_seed)

    ckpt = CheckpointManager(out_dir / "ckpt", max_to_keep=args.max_ckpt_save_num, log=logger)
    resume_step = None
    if args.ckpt:
        try:
            resume_step = int(args.ckpt)
        except ValueError:
            load_checkpoint(model, args.ckpt, logger)
            logger.info(f"loaded weights from {args.ckpt} (fresh optimizer)")
    t0 = time.perf_counter()
    state, resumed_from = ckpt.restore(resume_step)
    start_step = 0
    if state is not None:
        model.load_state_dict(state["model_state"], strict=True)
        optimizer.load_state_dict(state["optimizer_state"])
        start_step = int(state["step"])
        logger.info(f"auto-resumed from step {resumed_from}")
    resume_s = time.perf_counter() - t0
    _, train_step = make_train_step_for_cfg(model, optimizer, model_cfg,
                                            ddp=wrap_model(model, ctx))
    return Run(args, cfg, logger, out_dir, device, dataset, loader, model, optimizer,
               lr_schedule, train_step, ckpt, steps_per_epoch, epochs, total_steps,
               start_step, resumed_from, resume_s, tb, ctx)


def _profile_device_ms(prof) -> float:
    """The device's own events of a trace, summed (ms)."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def _augmentation(batch) -> dict:
    """How many frames of ``batch`` were flipped, and how many carry a
    ``lidar_aug_matrix`` other than the identity (rotated or scaled)."""
    aug = torch.as_tensor(batch["lidar_aug_matrix"])
    return {"frames": int(aug.shape[0]), "flipped": sum(map(bool, batch.get("flip_x", []))),
            "aug_matrix": int((aug != torch.eye(4)).flatten(1).any(1).sum())}


def fit(run: Run) -> dict:
    """The training loop from ``run.start_step``; returns what it measured:
    the steps, every step's loss, the host-clock rate after the first two
    steps (with and without the checkpoints saved inside the loop), the main
    thread's wait on the loader per step, the augmentations of the frames
    fed, each checkpoint's seconds and bytes, the profiled steps' device
    time and peak memory."""
    args, log, dev = run.args, run.logger, run.device
    end = run.total_steps
    if args.max_steps is not None:
        end = min(end, run.start_step + args.max_steps)
    prof_range = tuple(int(x) for x in args.profile_steps.split(":")) if args.profile_steps \
        else None
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    def checkpoint(step, wait: bool):
        """Rank 0 writes; with ``wait`` (a save every rank reaches at the
        same step) the others wait until the file is there."""
        saved = None
        if run.dist.is_main:
            saved = run.ckpt.save(step, {"model_state": run.model.state_dict(),
                                         "optimizer_state": run.optimizer.state_dict()})
        if wait and run.dist.world_size > 1:
            torch.distributed.barrier()
        return saved

    launches0 = dict(library.launches)
    losses, starts, waits, saves, augs = [], [], [], [], []
    in_loop_save_s = 0.0  # the saves inside the loop after its first two steps
    prof, profile_ms = None, None
    aug_disabled = False
    t_start = t_last_save = time.time()
    batch_iter = run.loader.batches()
    try:
        for step in range(run.start_step, end):
            if (args.disable_aug_last_epochs > 0 and not aug_disabled
                    and step >= (run.epochs - args.disable_aug_last_epochs) * run.steps_per_epoch):
                hook = run.cfg.get("HOOK", {}).get("DisableAugmentationHook", {})
                disable = set(hook.get("DISABLE_AUG_LIST", ["gt_sampling"]))
                aug = run.dataset.data_augmentor
                aug.queue = [(fn, c) for fn, c in aug.queue if c["NAME"] not in disable]
                log.info(f"augmentations {sorted(disable)} disabled for the final epochs")
                aug_disabled = True
            if prof_range and step == prof_range[0] and run.dist.is_main:
                activities = [torch.profiler.ProfilerActivity.CPU] + (
                    [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
                prof = torch.profiler.profile(activities=activities)
                prof.start()
            starts.append(time.perf_counter())
            batch = next(batch_iter)
            waits.append(time.perf_counter() - starts[-1])
            augs.append(_augmentation(batch))
            loss, tb = run.train_step(run.model.batch_to_device(batch))
            losses.append(loss)
            if prof is not None and step == prof_range[1]:
                if cuda:
                    torch.cuda.synchronize(dev)
                prof.stop()
                (run.out_dir / "profile").mkdir(exist_ok=True)
                trace = run.out_dir / "profile" / f"steps_{prof_range[0]}_{prof_range[1]}.json"
                prof.export_chrome_trace(str(trace))
                profile_ms = _profile_device_ms(prof) if cuda else None
                log.info(f"profiler trace written to {trace}")
                prof = None
            if step % LOG_EVERY == 0 or step == end - 1:
                metrics = {k: float(v) for k, v in tb.items()}
                lr = float(run.lr_schedule(step))
                log.info(f"step {step}/{run.total_steps} loss {metrics['loss']:.4f} ("
                         + " ".join(f"{k.replace('rpn_loss_', '').replace('loss_', '')} {v:.4f}"
                                    for k, v in sorted(metrics.items()) if k != "loss")
                         + f") lr {lr:.2e} {time.time() - t_start:.0f}s")
                if run.tb is not None:
                    for k, v in metrics.items():
                        run.tb.add_scalar(f"train/{k}", v, step)
                    run.tb.add_scalar("meta/learning_rate", lr, step)
            boundary = (step + 1) % run.steps_per_epoch == 0
            if boundary or (run.dist.is_main
                            and time.time() - t_last_save > args.ckpt_save_interval_s):
                saved = checkpoint(step + 1, wait=boundary)
                if saved is not None and len(starts) > 2:
                    in_loop_save_s += saved["seconds"]
                saves.append(saved)
                t_last_save = time.time()
                log.info(f"{'saved' if boundary else 'periodic'} checkpoint at step {step + 1}")
    finally:
        batch_iter.close()
        if prof is not None:
            prof.stop()
    if cuda:
        torch.cuda.synchronize(dev)
    loop_end = time.perf_counter()
    saves.append(checkpoint(max(end, run.start_step), wait=True))
    if run.tb is not None:
        run.tb.close()
    loss_values = torch.stack(losses).tolist() if losses else []
    steady = starts[2:]
    launches = {k: library.launches[k] - launches0[k] for k in launches0}
    log.info(f"kernel launches: {json.dumps(launches)}")
    if steady:
        log.info(f"{len(steady)} steps at {len(steady) / (loop_end - steady[0]):.3f} steps/s "
                 "after the first two (host clock, saves included)")
    log.info("training done")
    return {
        "start_step": run.start_step, "end_step": max(end, run.start_step),
        "resumed_from": run.resumed_from, "resume_s": run.resume_s,
        "steps": len(losses), "losses": loss_values,
        "steps_per_s": len(steady) / (loop_end - steady[0]) if steady else math.nan,
        "steps_per_s_excl_saves": (len(steady) / (loop_end - steady[0] - in_loop_save_s)
                                   if steady else math.nan),
        "loader_wait_s": waits,
        "augmentation": {k: sum(a[k] for a in augs) for k in ("frames", "flipped", "aug_matrix")},
        "saves": [s for s in saves if s is not None],
        "profile_device_ms": profile_ms,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
        "out_dir": str(run.out_dir),
        "launches": launches,
        "rank": run.dist.rank, "world_size": run.dist.world_size,
        "global_batch": run.loader.global_batch_size,
    }


def main(argv=None) -> dict:
    run = prepare(parse_args(argv))
    try:
        return fit(run)
    finally:
        shutdown(run.dist)


if __name__ == "__main__":
    main()
