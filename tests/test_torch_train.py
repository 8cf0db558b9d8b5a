"""The port's training step against the JAX package's ``make_train_step``.

TINY model (tests/test_model.py) with the Pallas sampler (interpret mode on
the JAX side, the plain backward on the port's), ``make_tiny_batch`` with its
Car and Pedestrian gt boxes, JAX init with randomized BN statistics and affine
parameters, and the frozen backbone's residual scales at 0 (so the step is
well conditioned: ``train/step_compare.py``), LOSS_WEIGHTS and OPTIM_CFG of
tests/test_train.py. One jitted JAX step is compiled once for the module.

Each of three steps starts from the initial parameters and BN statistics,
with the Adam moments and step count that JAX's own trajectory has before
that step, and both sides take it from there: the schedules and the moments
of steps 1-3 are exercised at the one state whose gradients are well
conditioned, and every step is held to ``step_compare.compare_steps``. The
trajectory itself is not comparable that tightly at this size: from the
parameters of a later step, ReLU inputs within rounding of 0 at positions
that carry the loss gradient switch between the two frameworks
(``tests/torch_step_conditioning.py`` measures it).
"""
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from hgsfusion_tpu.models.anchors import TargetAssigner as JaxAssigner
from hgsfusion_tpu.models.detector import HGSFusionModel as JaxModel
from hgsfusion_tpu.train.optim import build_optimizer as jax_build_optimizer
from hgsfusion_tpu.train.trainer import TrainState
from hgsfusion_tpu.train.trainer import make_train_step as jax_make_train_step
from hgsfusion_tpu_torch.models.anchors import TargetAssigner
from hgsfusion_tpu_torch.models.detector import HGSFusionModel
from hgsfusion_tpu_torch.train.optim import (FROZEN_PREFIX, AdamOneCycle, build_optimizer,
                                             onecycle_lr_schedule, onecycle_mom_schedule)
from hgsfusion_tpu_torch.train.step_compare import (GradCapture, compare_steps, perturb_inputs,
                                                    sensitivity, step_record)
from hgsfusion_tpu_torch.train.trainer import make_train_step
from hgsfusion_tpu_torch.weights import from_jax_variables
from test_model import ANCHOR_CFG, TINY, make_tiny_batch
from test_train import LOSS_WEIGHTS, OPTIM_CFG
from torch_parity import load, one_torch_thread, perturb_variables, port_config  # noqa: F401

TINY_PALLAS = dataclasses.replace(TINY, f2v_sampler_kernel="pallas")
TOTAL_STEPS = 20
STEPS = 3
BOTTLENECKS = 16  # ResNet-50: 3 + 4 + 6 + 3


def _capture():
    """An optax transformation that passes the gradients on and keeps them
    as its state, so the jitted step returns what it differentiated."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jax.numpy.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _zero_residual_scales(variables):
    """The JAX side of ``step_compare.zero_residual_scales``: every
    bottleneck's ``bn3`` scale at 0."""
    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path[-2:] == ("bn3", "scale") and any("_block" in p for p in path):
            return np.zeros_like(node)
        return node
    return {**variables, "params": walk(variables["params"])}


def _fill_masked(tree, params):
    """An optax moment tree with the frozen leaves' MaskedNode read as 0."""
    if isinstance(tree, optax.MaskedNode):
        return np.zeros_like(np.asarray(params))
    if isinstance(tree, dict):
        return {k: _fill_masked(v, params[k]) for k, v in tree.items()}
    return np.asarray(tree)


def _adam_state(state):
    """(count, mu, nu) of the adamw under the capture, the mask and the clip."""
    return state.opt_state[1].inner_states["train"].inner_state[1].inner_state[0]


def _port_tree(params, batch_stats):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            from_jax_variables({"params": params, "batch_stats": batch_stats}).items()}


def _jax_record(state, tb, names):
    """JAX's step in the form of ``step_compare.step_record``."""
    grads = _port_tree(state.opt_state[0], state.batch_stats)
    tree = _port_tree(state.params, state.batch_stats)
    return {"tb": {k: torch.tensor(float(v)) for k, v in tb.items()},
            "grads": {k: grads[k] for k in names},
            "params": {k: tree[k] for k in names},
            "stats": {k: v for k, v in tree.items()
                      if k.endswith(("running_mean", "running_var"))}}


def _port_step(state, batch, perturb_seed=None):
    """One port step from the JAX TrainState ``state``: its parameters, BN
    statistics, Adam moments and step count. Returns the step's record, its
    learning rate, and the frozen parameters that changed and the backbone
    statistics that did not."""
    cfg = port_config(TINY_PALLAS)
    model = load(HGSFusionModel(cfg, device="cpu"),
                 from_jax_variables({"params": state.params, "batch_stats": state.batch_stats}))
    opt, lr_schedule = build_optimizer(dict(OPTIM_CFG), TOTAL_STEPS, model)
    adam = _adam_state(state)
    names = [k for k, p in model.named_parameters() if p.requires_grad]
    moments = [_port_tree(_fill_masked(m, state.params), state.batch_stats)
               for m in (adam.mu, adam.nu)]
    for i, k in enumerate(names):
        opt.mu[i].copy_(moments[0][k])
        opt.nu[i].copy_(moments[1][k])
    opt.count.fill_(int(adam.count))
    cap = GradCapture(opt)
    step = make_train_step(model, TargetAssigner(cfg.anchor_generator, cfg.grid_size,
                                                 cfg.pc_range, cfg.class_names, device="cpu"),
                           cap, LOSS_WEIGHTS, cfg)
    pbatch = model.batch_to_device({k: np.asarray(v) for k, v in batch.items()})
    if perturb_seed is not None:
        pbatch = perturb_inputs(pbatch, perturb_seed)
    before = {k: v.clone() for k, v in model.state_dict().items() if k.startswith(FROZEN_PREFIX)}
    _, tb = step(pbatch)
    after = model.state_dict()
    frozen_changed = [k for k, v in before.items() if k.endswith(("weight", "bias"))
                      and not torch.equal(after[k], v)]
    stats_still = [k for k, v in before.items() if k.endswith(("running_mean", "running_var"))
                   and torch.equal(after[k], v)]
    return (step_record(model, cap, tb), float(lr_schedule(int(adam.count))),
            frozen_changed, stats_still)


@pytest.fixture(scope="module")
def runs():
    """Per step, JAX's and the port's records from the same start (the
    initial parameters and statistics, the optimizer state of JAX's
    trajectory before the step), the learning rates, the frozen-backbone
    findings, the port's sensitivity at that start, and JAX's trajectory
    (its gradients and parameters after each step)."""
    torch.set_num_threads(1)
    batch = make_tiny_batch(np.random.RandomState(0))
    jmodel = JaxModel(cfg=TINY_PALLAS)
    variables = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, False))(batch)
    variables = _zero_residual_scales(perturb_variables(variables, seed=1))
    tx, jax_lr = jax_build_optimizer(OPTIM_CFG, total_steps=TOTAL_STEPS,
                                     params=variables["params"])
    tx = optax.chain(_capture(), tx)
    assigner = JaxAssigner(ANCHOR_CFG, TINY.grid_size, TINY.pc_range,
                           class_names=TINY.class_names)
    jstep = jax.jit(jax_make_train_step(jmodel, assigner, tx, LOSS_WEIGHTS, TINY_PALLAS))
    first = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=jax.jit(tx.init)(variables["params"]),
                       step=np.zeros((), np.int32))
    out = {"ref": [], "got": [], "lr": [], "frozen_changed": [], "stats_still": [],
           "trajectory": [], "init": _port_tree(first.params, first.batch_stats)}
    trajectory = first
    for i in range(STEPS):
        start = first.replace(opt_state=trajectory.opt_state, step=trajectory.step)
        got, lr, frozen_changed, stats_still = _port_step(start, batch)
        if i == 0:
            probes = [_port_step(start, batch, seed)[0]["grads"] for seed in (1, 2)]
            out["sens"] = sensitivity(got["grads"], probes)
        after, tb = jstep(start, batch)
        out["ref"].append(_jax_record(after, tb, list(got["grads"])))
        for k, v in (("got", got), ("lr", lr), ("frozen_changed", frozen_changed),
                     ("stats_still", stats_still)):
            out[k].append(v)
        trajectory = after if i == 0 else jstep(trajectory, batch)[0]
        out["trajectory"].append(_jax_record(trajectory, tb, list(got["grads"])))
    out["names"] = list(out["got"][0]["grads"])
    out["jax_lr"] = [float(jax_lr(i)) for i in range(STEPS)]
    return out


def test_residual_scales_are_zero_only_in_the_backbone(runs):
    zero = [k for k, v in runs["init"].items()
            if k.endswith("bn3.weight") and not bool(v.any())]
    assert len(zero) == BOTTLENECKS and all(k.startswith(FROZEN_PREFIX) for k in zero)


def test_one_step_matches_jax(runs):
    ref, got = runs["ref"][0], runs["got"][0]
    assert set(got["tb"]) == {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss",
                              "loss_occ", "loss"}
    report = compare_steps(ref, got, runs["sens"], runs["lr"][0])
    print(f"step 1: {report}")


def test_optimizer_matches_optax_on_the_same_gradients(runs):
    """The gradients of JAX's trajectory fed to the port's AdamOneCycle give
    its parameters after each step: the clip, the beta1 schedule in the
    moments and the bias correction, the decoupled decay and the LR
    schedule."""
    names = runs["names"]
    params = [runs["init"][k].clone() for k in names]
    cfg = OPTIM_CFG
    opt = AdamOneCycle(
        params,
        onecycle_lr_schedule(TOTAL_STEPS, cfg.LR, cfg.DIV_FACTOR, cfg.PCT_START),
        onecycle_mom_schedule(TOTAL_STEPS, cfg.MOMS, cfg.PCT_START),
        cfg.WEIGHT_DECAY, cfg.GRAD_NORM_CLIP)
    np.testing.assert_allclose(runs["lr"], runs["jax_lr"], rtol=1e-6)
    for ref in runs["trajectory"]:
        opt.step([ref["grads"][k] for k in names])
        for k, p in zip(names, params):
            np.testing.assert_allclose(p.numpy(), ref["params"][k].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def test_backbone_frozen_and_its_statistics_move(runs):
    assert not any(k.startswith(FROZEN_PREFIX) for k in runs["names"])
    for i in range(STEPS):
        assert runs["frozen_changed"][i] == [], f"step {i + 1}"
        assert runs["stats_still"][i] == [], f"step {i + 1}"


def test_three_steps_match_jax(runs):
    """Each of the three steps from the initial parameters with the optimizer
    state of JAX's trajectory before it: the schedules at steps 1-3 and
    Adam's moments of the steps before, held tightly."""
    for i in range(STEPS):
        report = compare_steps(runs["ref"][i], runs["got"][i], runs["sens"], runs["lr"][i])
        print(f"step {i + 1}: {report}")
