"""Rank functions of the port's data-parallel tests (tests/test_torch_ddp.py,
tests/test_torch_multihost.py), run in gloo process groups by
``parallel.spawn.spawn_ranks``. Imports torch and the port only, so that the
spawned processes start quickly; each returns host tensors or numpy."""
import numpy as np
import torch
import torch.nn as nn

from hgsfusion_tpu_torch.models.anchors import TargetAssigner
from hgsfusion_tpu_torch.models.detector import HGSFusionModel
from hgsfusion_tpu_torch.models.layers import MaskedBatchNorm, batch_norm, batch_norm_joint
from hgsfusion_tpu_torch.parallel import mesh, multihost
from hgsfusion_tpu_torch.train.optim import build_optimizer
from hgsfusion_tpu_torch.train.step_compare import (GradCapture, perturb_inputs, step_record,
                                                    zero_residual_scales)
from hgsfusion_tpu_torch.train.trainer import make_train_step

BN_CHANNELS = 6
BATCH = 4  # frames of the global batch in the BatchNorm cases


def bn_inputs(case: str):
    """The global batch of one BatchNorm case: the inputs, the mask (masked
    case), the output weights of the test loss sum(out * w)."""
    rng = np.random.RandomState(7)
    c = BN_CHANNELS
    if case == "joint":
        xs = [rng.randn(BATCH, 5, 6, c) * 2 + 1, rng.randn(BATCH, 7, c) - 0.5]
    elif case == "nchw":
        xs = [rng.randn(BATCH, c, 5, 4) * 3 + 2]
    else:  # "nhwc", "masked"
        xs = [rng.randn(BATCH, 5, 6, c) * 2 + 1]
    mask = (rng.rand(BATCH, 5, 6, 1) < np.array([0.2, 0.5, 0.7, 0.9])[:, None, None, None])
    ws = [rng.randn(*x.shape) for x in xs]
    return ([torch.tensor(x, dtype=torch.float32) for x in xs],
            torch.tensor(mask, dtype=torch.float32), [torch.tensor(w, dtype=torch.float32)
                                                      for w in ws])


def bn_module(case: str):
    torch.manual_seed(3)
    m = MaskedBatchNorm(BN_CHANNELS) if case == "masked" else nn.BatchNorm2d(BN_CHANNELS)
    with torch.no_grad():
        m.weight.uniform_(0.5, 1.5)
        m.bias.normal_()
        m.running_mean.normal_()
        m.running_var.uniform_(0.5, 2.0)
    return m.train()


def bn_run(case: str, lo: int = 0, hi: int = BATCH) -> dict:
    """One train-mode call of the case's BatchNorm on frames [lo, hi) of the
    global batch, and the backward pass of sum(out * w): outputs, input,
    weight and bias gradients, running statistics."""
    xs, mask, ws = bn_inputs(case)
    xs = [x[lo:hi].clone().requires_grad_(True) for x in xs]
    m = bn_module(case)
    if case == "masked":
        outs = [m(xs[0], mask[lo:hi])]
    elif case == "joint":
        outs = batch_norm_joint(xs, m)
    else:
        outs = [batch_norm(xs[0], m, dim=1 if case == "nchw" else -1)]
    loss = sum((o * w[lo:hi]).sum() for o, w in zip(outs, ws))
    loss.backward()
    return {"out": [o.detach() for o in outs], "x_grad": [x.grad for x in xs],
            "weight_grad": m.weight.grad, "bias_grad": m.bias.grad,
            "running_mean": m.running_mean.clone(), "running_var": m.running_var.clone()}


def bn_rank(ctx, cases):
    per = BATCH // ctx.world_size
    return {case: bn_run(case, ctx.rank * per, (ctx.rank + 1) * per) for case in cases}


def train_steps(ctx, cfg, batch, steps: int, seed: int, perturb_seed=None):
    """``steps`` training steps of the model from ``seed`` (its backbone's
    residual scales at 0) on ``batch``, this rank's slice of it under a
    process group (``ctx`` None: one process, no DDP): each step's
    ``step_record`` and the first step's learning rate."""
    torch.set_num_threads(1)
    model = zero_residual_scales(HGSFusionModel(cfg, device="cpu", seed=seed))
    assigner = TargetAssigner(cfg.anchor_generator, cfg.grid_size, cfg.pc_range,
                              cfg.class_names, device="cpu")
    opt, lr_schedule = build_optimizer(cfg.optimization, 100, model)
    cap = GradCapture(opt)
    ddp = None if ctx is None else mesh.wrap_model(model, ctx)
    step = make_train_step(model, assigner, cap, cfg.loss_weights, cfg, ddp=ddp)
    if ctx is not None:
        batch = mesh.rank_slice(batch, ctx.rank, ctx.world_size)
    b = model.batch_to_device(batch)
    if perturb_seed is not None:
        b = perturb_inputs(b, perturb_seed)
    records = []
    for _ in range(steps):
        _, tb = step(b)
        records.append(step_record(model, cap, tb))
    return records, float(lr_schedule(0))


def eval_rank(ctx, cfg, model_cfg, seed: int, frames: int):
    """``tools.test.run_eval`` of this rank's shard of the tree of ``cfg``,
    then the merges' own checks: the strided shard served, the recall
    counts summed and an object list merged across the ranks."""
    from hgsfusion_tpu_torch.datasets import build_dataset
    from hgsfusion_tpu_torch.tools.test import run_eval
    from hgsfusion_tpu_torch.utils.common import create_logger

    torch.set_num_threads(1)
    logger = create_logger(rank=ctx.rank)
    ds = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False, logger=logger)
    model = HGSFusionModel(model_cfg, device="cpu", seed=seed)
    annos, result, stats = run_eval(cfg, model, ds, logger, max_frames=frames)
    part = [f"frame {i}" for i in multihost.shard_indices_for_host(frames)]
    return {"annos": annos, "result": result, "stats": {k: stats[k] for k in (
                "frames", "frames_served", "recall", "total_gt")},
            "shard": multihost.shard_indices_for_host(frames),
            "merged": multihost.merge_anno_lists_across_hosts(part, frames),
            "scalars": multihost.allreduce_host_scalars({"a": ctx.rank + 1, "b": 0.5})}
