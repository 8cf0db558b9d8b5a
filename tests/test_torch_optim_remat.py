"""The ``adam`` and ``sgd`` optimizers against optax, and ``REMAT`` on against
off, on the CPU.

The optimizers run three steps on a small tree with a frozen leaf (the
global-norm clip triggered at one of them) beside the JAX package's optax
chain, then resume from a ``state_dict`` bit for bit. REMAT recomputes the
gather f2v's sample + reduce product (with and without depth) and the polar
view's pass 2 in the backward pass: one TINY training step with it on must
equal the step with it off bit for bit (loss terms, gradients, updated
parameters, BN statistics updated once), and the recomputation must run.
"""
import dataclasses

import numpy as np
import optax
import pytest
import torch

from hgsfusion_tpu.config import ConfigDict
from hgsfusion_tpu.train import optim as joptim
from hgsfusion_tpu_torch.models import frustum, polar_f2v
from hgsfusion_tpu_torch.models.anchors import TargetAssigner
from hgsfusion_tpu_torch.models.detector import HGSFusionModel
from hgsfusion_tpu_torch.train import optim
from hgsfusion_tpu_torch.train.step_compare import GradCapture, step_record
from hgsfusion_tpu_torch.train.trainer import make_train_step
from test_model import TINY, make_tiny_batch
from test_train import LOSS_WEIGHTS, OPTIM_CFG
from torch_parity import assert_close, one_torch_thread, port_config, t  # noqa: F401

SHAPES = {"ddn_backbone": {"w": (4, 3)}, "head": {"w": (5, 3), "b": (5,)},
          "neck": {"w": (2, 2, 3)}}


def _tree_module(params):
    """A torch module with ``params``' leaves, the ``ddn_backbone`` one under
    the port's frozen prefix; returns (module, {(m, k): parameter})."""
    module = torch.nn.Module()
    node = module
    for part in optim.FROZEN_PREFIX.rstrip(".").split("."):
        setattr(node, part, torch.nn.Module())
        node = getattr(node, part)
    leaf = {}
    for m, d in params.items():
        for k, v in d.items():
            owner, name = (node, k) if m == "ddn_backbone" else (module, f"{m}_{k}")
            owner.register_parameter(name, torch.nn.Parameter(t(v.copy())))
            leaf[(m, k)] = getattr(owner, name)
    return module, leaf


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_matches_optax_and_resumes(name):
    """Three steps against the JAX package's chain (clip_by_global_norm, then
    adamw(LR, weight_decay) or add_decayed_weights + sgd(LR, MOMENTUM), the
    frozen leaf masked), then a resume from the state after step 2 that
    gives step 3 bit for bit."""
    cfg = {**dict(OPTIM_CFG), "OPTIMIZER": name, "MOMENTUM": 0.8}
    rng = np.random.RandomState(5)
    params = {m: {k: rng.randn(*s).astype(np.float32) for k, s in d.items()}
              for m, d in SHAPES.items()}
    tx, _ = joptim.build_optimizer(ConfigDict(cfg), 20, params)
    state = tx.init(params)
    module, leaf = _tree_module(params)
    opt, lr_schedule = optim.build_optimizer(cfg, 20, module)
    frozen = leaf[("ddn_backbone", "w")]
    assert not frozen.requires_grad and len(opt.params) == 3
    assert float(lr_schedule(7)) == cfg["LR"]
    index = {id(p): mk for mk, p in leaf.items()}
    p_ref = params
    grads = []
    for step in range(3):
        scale = 30.0 if step == 1 else 1.0  # step 2's gradients trip the clip
        g = {m: {k: (scale * rng.randn(*s)).astype(np.float32) for k, s in d.items()}
             for m, d in SHAPES.items()}
        grads.append([t(g[index[id(p)][0]][index[id(p)][1]]) for p in opt.params])
        upd, state = tx.update(g, state, p_ref)
        p_ref = optax.apply_updates(p_ref, upd)
        if step == 2:
            resumed_params = {mk: p.detach().clone() for mk, p in leaf.items()}
            module2, leaf2 = _tree_module({m: {k: resumed_params[(m, k)].numpy()
                                               for k in d} for m, d in params.items()})
            opt2, _ = optim.build_optimizer(cfg, 20, module2)
            opt2.load_state_dict({k: [x.clone() for x in v] if isinstance(v, list) else v.clone()
                                  for k, v in opt.state_dict().items()})
            opt2.step(grads[-1])
        opt.step(grads[-1])
        for (m, k), p in leaf.items():
            assert_close(p, p_ref[m][k], atol=1e-7, rtol=1e-6, err_msg=f"step {step} {m}.{k}")
    np.testing.assert_array_equal(frozen.detach().numpy(), params["ddn_backbone"]["w"])
    for mk, p in leaf.items():
        assert torch.equal(p, leaf2[mk]), mk
    for a, b in zip(opt.state_dict().values(), opt2.state_dict().values()):
        for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
            assert torch.equal(x, y)
    with pytest.raises(NotImplementedError):
        optim.build_optimizer({**cfg, "OPTIMIZER": "lamb"}, 20, module)


def _batch(depth: bool):
    rng = np.random.RandomState(0)
    batch = {k: np.asarray(v) for k, v in make_tiny_batch(rng).items()}
    if depth:
        batch["depth_maps"] = rng.uniform(0.5, 18.0, (1, 16, 24)).astype(np.float32)
        batch["gt_boxes2d"] = np.array([[[10, 12, 41, 37]]], np.float32)
    return batch


def _step(cfg, batch):
    model = HGSFusionModel(cfg, device="cpu", seed=2)
    opt, _ = optim.build_optimizer(dict(OPTIM_CFG), 20, model)
    cap = GradCapture(opt)
    step = make_train_step(model, TargetAssigner(cfg.anchor_generator, cfg.grid_size,
                                                 cfg.pc_range, cfg.class_names, device="cpu"),
                           cap, LOSS_WEIGHTS, cfg)
    _, tb = step(model.batch_to_device(batch))
    tracked = {k: int(v) for k, v in model.state_dict().items()
               if k.endswith("num_batches_tracked")}
    return step_record(model, cap, tb), tracked


@pytest.mark.parametrize("view,depth", [("gather", True), ("gather", False), ("polar", False)])
def test_remat_equals_no_remat(view, depth, monkeypatch):
    base = port_config(TINY, use_depth=depth, f2v_view=view, f2v_sampler_kernel="xla")
    batch = _batch(depth)
    # the recomputed part: the gather f2v's product, the polar view's pass 2
    calls = {"n": 0}
    target = (frustum.FrustumToVoxelMultiScale, "accumulate") if view == "gather" \
        else (polar_f2v, "_hat_weights")
    inner = getattr(*target)

    def counted(*a, **k):
        calls["n"] += 1
        return inner(*a, **k)

    monkeypatch.setattr(*target, counted)
    off, tracked_off = _step(dataclasses.replace(base, remat=False), batch)
    n_off, calls["n"] = calls["n"], 0
    on, tracked_on = _step(dataclasses.replace(base, remat=True), batch)
    assert calls["n"] == 2 * n_off > 0  # each forward of the part ran again in the backward
    assert set(on["tb"]) == set(off["tb"]) and ("ddn_loss" in on["tb"]) == depth
    for part in ("tb", "grads", "params", "stats"):
        for k, v in off[part].items():
            assert torch.equal(on[part][k], v), f"{part} {k}"
    # every BatchNorm's statistics updated once in the step, the f2v's too
    assert tracked_on == tracked_off and set(tracked_on.values()) <= {0, 1}
    assert tracked_on["fusion_vfe.image_vfe.f2v.channel_reduce.1.num_batches_tracked"] == 1
