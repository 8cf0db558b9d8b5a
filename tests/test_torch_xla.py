"""``F2V.SAMPLER_KERNEL: xla`` (the paper's own ``configs/hgsfusion_vod.yaml``)
on the port against the JAX package's XLA sampler path, on the CPU.

The YAML is cut to the TINY model of tests/test_model.py (as
tests/test_torch_eval.py cuts it: 16x8 m at 0.5 m, a 64x96 image, ResNet-50,
16 depth bins, f32) and keeps ``BEV_AUG: True``; the batch is
``make_tiny_batch`` with a rotated and scaled ``lidar_aug_matrix``. JAX
weights (BN statistics perturbed) are carried across by
``weights.from_jax_variables``. Serving is held to 1e-4, one training step
(the frozen backbone's residual scales at 0) to ``train/step_compare.py``'s
bounds. The f2v module alone in bf16 gives the difference between JAX's XLA
sampler (a rounding after each tap) and the port's kernel path (one)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hgsfusion_tpu.config import ConfigDict
from hgsfusion_tpu.config import load_config as jax_load_config
from hgsfusion_tpu.config import model_config_from_yaml as jax_model_config
from hgsfusion_tpu.models.anchors import TargetAssigner as JaxAssigner
from hgsfusion_tpu.models.detector import HGSFusionModel as JaxModel
from hgsfusion_tpu.models.frustum import FrustumToVoxelMultiScale as JaxF2V
from hgsfusion_tpu.train.optim import build_optimizer as jax_build_optimizer
from hgsfusion_tpu.train.trainer import TrainState
from hgsfusion_tpu.train.trainer import make_train_step as jax_make_train_step
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.config import load_config, model_config_from_yaml, vod_pallas_config
from hgsfusion_tpu_torch.models.anchors import TargetAssigner
from hgsfusion_tpu_torch.models.detector import HGSFusionModel
from hgsfusion_tpu_torch.models.frustum import FrustumToVoxelMultiScale
from hgsfusion_tpu_torch.train.optim import build_optimizer
from hgsfusion_tpu_torch.train.step_compare import (GradCapture, compare_steps, perturb_inputs,
                                                    sensitivity, step_record)
from hgsfusion_tpu_torch.train.trainer import make_train_step
from hgsfusion_tpu_torch.weights import from_jax_variables
from test_model import make_tiny_batch
from test_torch_eval import _tiny_cfg
from test_torch_train import _capture, _jax_record, _zero_residual_scales
from torch_parity import assert_close, load, one_torch_thread, perturb_variables, t  # noqa: F401

YAML = "configs/hgsfusion_vod.yaml"
HEAD_TOL = 1e-4  # as tests/test_torch_detector.py
TOTAL_STEPS = 20
# the f2v module in bf16: JAX's XLA sampler rounds each tap's product and
# sum in bf16, the port's kernel path sums in f32 and rounds once; the
# outputs (after the f32-accumulated reduce, BN and ReLU, in bf16) stay
# within a few bf16 roundings of the largest value
BF16_REL_TOL = 2.0 ** -6


def test_vod_yaml_is_the_pallas_preset_but_its_sampler():
    cfg = model_config_from_yaml(load_config(YAML))
    assert cfg.f2v_sampler_kernel == "xla"
    assert dataclasses.replace(cfg, f2v_sampler_kernel="pallas") == vod_pallas_config()
    assert jax_model_config(jax_load_config(YAML)).f2v_sampler_kernel == "xla"


@pytest.fixture(scope="module")
def tiny():
    """Both configs, the batch, and one set of JAX variables."""
    pcfg = model_config_from_yaml(_tiny_cfg(load_config(YAML), "unused"))
    jcfg = ConfigDict(_tiny_cfg(jax_load_config(YAML), "unused"))
    jm = jax_model_config(jcfg)
    assert (pcfg.f2v_sampler_kernel, jm.f2v_sampler_kernel) == ("xla", "xla")
    assert pcfg.bev_aug and jm.bev_aug
    batch = make_tiny_batch(np.random.RandomState(0))
    a, s = 0.2, 1.03  # a world rotation and scaling, which BEV_AUG undoes
    aug = np.eye(4, dtype=np.float32)
    aug[:3, :3] = s * np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                                [0, 0, 1]], np.float32)
    batch = {**{k: np.asarray(v) for k, v in batch.items()}, "lidar_aug_matrix": aug[None]}
    jmodel = JaxModel(cfg=jm)
    variables = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, False))(batch)
    variables = perturb_variables(variables, seed=1)
    return {"pcfg": pcfg, "jcfg": jcfg, "jm": jm, "jmodel": jmodel, "batch": batch,
            "variables": variables}


def test_serve_matches_jax_xla(tiny):
    jmodel, v, batch = tiny["jmodel"], tiny["variables"], tiny["batch"]
    ref, _ = jax.jit(lambda vv, b: jmodel.apply(vv, b, False, mutable=["batch_stats"]))(v, batch)
    model = load(HGSFusionModel(tiny["pcfg"], device="cpu"), from_jax_variables(v))
    with torch.no_grad():
        got = model(model.batch_to_device(batch))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert_close(got[k], np.asarray(ref[k]), atol=HEAD_TOL, rtol=HEAD_TOL, err_msg=k)


def _port_step(pcfg, variables, batch, perturb_seed=None):
    model = load(HGSFusionModel(pcfg, device="cpu"), from_jax_variables(variables))
    opt, lr_schedule = build_optimizer(pcfg.optimization, TOTAL_STEPS, model)
    cap = GradCapture(opt)
    assigner = TargetAssigner(pcfg.anchor_generator, pcfg.grid_size, pcfg.pc_range,
                              pcfg.class_names, device="cpu")
    step = make_train_step(model, assigner, cap, pcfg.loss_weights, pcfg)
    b = model.batch_to_device(batch)
    if perturb_seed is not None:
        b = perturb_inputs(b, perturb_seed)
    _, tb = step(b)
    return step_record(model, cap, tb), float(lr_schedule(0))


def test_train_step_matches_jax_xla(tiny):
    jcfg, jm, pcfg = tiny["jcfg"], tiny["jm"], tiny["pcfg"]
    # the identity matrix: with the rotated one this TINY step is
    # ill-conditioned (step_compare.SENS_CAP)
    batch = {**tiny["batch"], "lidar_aug_matrix": np.eye(4, dtype=np.float32)[None]}
    variables = _zero_residual_scales(tiny["variables"])
    tx, _ = jax_build_optimizer(jcfg.OPTIMIZATION, total_steps=TOTAL_STEPS,
                                params=variables["params"])
    tx = optax.chain(_capture(), tx)
    assigner = JaxAssigner([dict(c) for c in jcfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG],
                           jm.grid_size, jm.pc_range, class_names=jm.class_names)
    loss_weights = dict(jcfg.MODEL.DENSE_HEAD.LOSS_CONFIG.LOSS_WEIGHTS)
    jstep = jax.jit(jax_make_train_step(tiny["jmodel"], assigner, tx, loss_weights, jm))
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=jax.jit(tx.init)(variables["params"]),
                       step=np.zeros((), np.int32))
    got, lr = _port_step(pcfg, variables, batch)
    probes = [_port_step(pcfg, variables, batch, s)[0]["grads"] for s in (1, 2)]
    after, tb = jstep(state, batch)
    ref = _jax_record(after, tb, list(got["grads"]))
    report = compare_steps(ref, got, sensitivity(got["grads"], probes), lr)
    print(f"xla step: {report}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_f2v_xla_sampler_matches_jax(dtype):
    """The gather view transform in eval mode; in bf16 the difference is
    printed and bounded (ROADMAP queue 3 records it)."""
    rng = np.random.RandomState(2)
    feats = [rng.randn(1, 9, 13, 16).astype(np.float32)] + [
        rng.randn(1, 5, 7, 16).astype(np.float32) for _ in range(3)]
    grid = rng.uniform(-1.2, 1.2, (1, 6, 7, 5, 3)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    jf2v = JaxF2V(out_channels=24, sampler_kernel="xla", dtype=jdt)
    v = perturb_variables(jf2v.init(jax.random.PRNGKey(0), feats, grid, False), seed=3)
    cast = [f.astype(jnp.bfloat16) if jdt else f for f in feats]
    ref = np.asarray(jf2v.apply(v, cast, grid, False, mutable=["batch_stats"])[0], np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    f2v = load(FrustumToVoxelMultiScale([16] * 4, 24, dtype=tdt, sampler_kernel="xla"),
               weights.frustum_to_voxel(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = f2v([t(f, tdt) for f in feats], t(grid)).float().numpy()
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    print(f"f2v {dtype}: max |port - jax xla| {err:.3g} of max {scale:.3g} "
          f"({err / scale:.3g}); mean {float(np.abs(got - ref).mean()):.3g}")
    assert err <= (1e-5 if dtype == "float32" else BF16_REL_TOL) * scale
