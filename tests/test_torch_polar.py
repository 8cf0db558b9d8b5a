"""The port's polar view transform (``hgsfusion_tpu_torch/models/polar_f2v.py``,
``F2V.VIEW: polar``) against the JAX package's, on the CPU, in f32.

Inputs are made with numpy from a seed. The port samples with the plain
versions of its kernels (CPU tensors); the JAX side samples with XLA's
``grid_sample_2d_quad``, as its own tests run it. Geometry of
``tests/test_polar_f2v.py``: GRID (64, 48, 8), IMG (64, 96), two 64-channel
scales at /4 and /8, OUTC 32, BEVC 24, B = 2.
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hgsfusion_tpu.config import load_config as jax_load_config
from hgsfusion_tpu.config import model_config_from_yaml as jax_model_config
from hgsfusion_tpu.models import polar_f2v as JP
from hgsfusion_tpu.models.anchors import TargetAssigner as JaxAssigner
from hgsfusion_tpu.models.detector import HGSFusionModel as JaxModel
from hgsfusion_tpu.train.optim import build_optimizer as jax_build_optimizer
from hgsfusion_tpu.train.trainer import TrainState
from hgsfusion_tpu.train.trainer import make_train_step as jax_make_train_step
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.config import load_config, model_config_from_yaml, vod_polar_config
from hgsfusion_tpu_torch.models import polar_f2v as P
from hgsfusion_tpu_torch.models.anchors import TargetAssigner
from hgsfusion_tpu_torch.models.detector import HGSFusionModel
from hgsfusion_tpu_torch.models.occupancy import Conv2DCollapse
from hgsfusion_tpu_torch.train.optim import build_optimizer
from hgsfusion_tpu_torch.train.step_compare import (GradCapture, compare_steps, perturb_inputs,
                                                    sensitivity, step_record)
from hgsfusion_tpu_torch.train.trainer import make_train_step
from hgsfusion_tpu_torch.weights import from_jax_variables
from test_model import ANCHOR_CFG, TINY, make_tiny_batch
from test_polar_f2v import BEVC, GRID, IMG, OUTC, PC, _calib
from test_torch_detector import HEAD_TOL
from test_torch_train import _capture, _jax_record, _zero_residual_scales
from test_train import LOSS_WEIGHTS, OPTIM_CFG
from torch_parity import (assert_close, load, one_torch_thread,  # noqa: F401
                          perturb_variables, port_config, t)

YAML = "configs/hgsfusion_vod_polar.yaml"
TINY_POLAR = dataclasses.replace(TINY, f2v_view="polar")
KEY = jax.random.PRNGKey(0)
# the polar image BEV, relative to its largest value: the hat weights are
# continuous in v0, and v0 comes out of a division whose last bits differ
# between XLA and PyTorch, so a row weight may differ by a few f32 roundings
# of v0 times the feature it multiplies
BEV_TOL = 1e-4
# train-mode gradients, relative to the largest (as
# tests/test_torch_train_modules.py holds its modules)
GRAD_TOL = 2e-5


def _feats(rng, b):
    h, w = IMG
    return [rng.randn(b, h // 4, w // 4, 64).astype(np.float32),
            rng.randn(b, h // 8, w // 8, 64).astype(np.float32)]


def _bda(b):
    """A non-identity lidar augmentation: a rotation about z, a scale and a
    shift."""
    c, s = np.cos(0.1), np.sin(0.1)
    m = np.array([[c, -s, 0, 0.3], [s, c, 0, -0.2], [0, 0, 1, 0.05], [0, 0, 0, 1]], np.float32)
    m[:3, :3] *= 1.03
    return np.tile(m, (b, 1, 1))


class _JaxPolar(nn.Module):
    """JAX's polar_image_bev under the scope names of the detector."""
    zeta_bins: int = 64
    near_columns: int = 8
    bev_aug: bool = False

    @nn.compact
    def __call__(self, feats, l2c, c2i, bda, train):
        return JP.polar_image_bev(
            JP._F2VScope(sum_channels=sum(f.shape[-1] for f in feats), out_channels=OUTC,
                         name="f2v"),
            JP._CollapseScope(in_channels=OUTC, nz=GRID[2], out_channels=BEVC,
                              name="map_to_bev"),
            feats, l2c, c2i, IMG, bda, train, grid_size=GRID, pc_range=PC,
            zeta_bins=self.zeta_bins, near_columns=self.near_columns, bev_aug=self.bev_aug)


def _port_pair(variables):
    p, s = variables["params"], variables["batch_stats"]
    f2v = P.PolarF2V(128, OUTC)
    f2v.load_state_dict(weights.frustum_to_voxel(p["f2v"], s["f2v"]), strict=True)
    collapse = Conv2DCollapse(OUTC, GRID[2], BEVC)
    collapse.load_state_dict(weights.conv2d_collapse(p["map_to_bev"], s["map_to_bev"]),
                             strict=True)
    return f2v, collapse


def _port_bev(f2v, collapse, feats, l2c, c2i, bda, jm):
    return P.polar_image_bev(f2v, collapse, feats, t(l2c), t(c2i), IMG,
                             None if bda is None else t(bda), grid_size=GRID, pc_range=PC,
                             zeta_bins=jm.zeta_bins, near_columns=jm.near_columns,
                             bev_aug=jm.bev_aug)


def _case(name, b=2):
    rng = np.random.RandomState(20)
    tilt = 0.05 if name == "tilted" else 0.0
    l2c, c2i = _calib(b, tilt=tilt)
    bda = _bda(b) if name == "bev_aug" else None
    jm = _JaxPolar(near_columns=0 if name == "no_near" else 8, bev_aug=name == "bev_aug")
    return jm, _feats(rng, b), l2c, c2i, bda


# ------------------------------------------------------------------ helpers


def _matrix(tilt=0.13):
    l2c, c2i = _calib(1, tilt=tilt)
    return (c2i[0] @ l2c[0]).astype(np.float32)


@pytest.mark.parametrize("name", ["project_uv_zeta", "solve_cell", "v_exact", "shear_rows",
                                  "hat_weights", "resample_cols"])
def test_helper_matches_jax(name):
    rng = np.random.RandomState(21)
    m = _matrix()
    z_ref = 0.5 * (PC[2] + PC[5])
    if name == "project_uv_zeta":
        # x < 0 puts cells behind the camera: the sentinel u = -1e9, zeta = 0
        x = rng.uniform(-6.0, 25.0, (40, 1)).astype(np.float32)
        y = rng.uniform(-12.0, 12.0, (1, 30)).astype(np.float32)
        ref = JP._project_uv_zeta(jnp.asarray(m), x, y, z_ref)
        got = P._project_uv_zeta(t(m), t(x), t(y), z_ref)
        assert float(got[0].min()) == -1e9 and float(got[1].min()) == 0.0
    elif name in ("solve_cell", "v_exact"):
        u = rng.uniform(-40.0, 130.0, (50, 1)).astype(np.float32)
        zeta = rng.uniform(0.04, 1.0, (50, 1)).astype(np.float32)
        if name == "solve_cell":
            ref = JP._solve_cell(jnp.asarray(m), u, zeta, z_ref)
            got = P._solve_cell(t(m), t(u), t(zeta), z_ref)
        else:
            z = np.linspace(PC[2], PC[5], 8, dtype=np.float32)[None, :]
            ref = (JP._v_exact(jnp.asarray(m), u, zeta, z, z_ref),)
            got = (P._v_exact(t(m), t(u), t(zeta), t(z), z_ref),)
    elif name == "shear_rows":
        src = rng.randn(2, 12, 5, 4).astype(np.float32)
        shift = rng.uniform(-14.0, 14.0, (2, 5)).astype(np.float32)  # some all out of range
        ref = (JP._shear_rows(jnp.asarray(src), jnp.asarray(shift)),)
        got = (P._shear_rows(t(src), t(shift)),)
    elif name == "hat_weights":
        v0 = rng.uniform(-2.5, 12.5, (3, 17)).astype(np.float32)
        ref = (JP._hat_weights(jnp.asarray(v0), 10),)
        got = (P._hat_weights(t(v0), 10),)
    else:
        src = rng.randn(2, 6, 11, 4).astype(np.float32)
        ref = tuple(JP._resample_cols(jnp.asarray(src), 3, n, r)
                    for n, r in ((21, 0.5), (10, 2.0), (15, 1.0)))
        got = tuple(P._resample_cols(t(src), 3, n, r) for n, r in ((21, 0.5), (10, 2.0), (15, 1.0)))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        assert_close(g, r, atol=1e-6 * max(1.0, float(np.abs(r).max())), rtol=1e-6)


def test_geometry_matches_jax_pieces():
    """``polar_geometry``'s pass-3 coordinates hold JAX's arithmetic on the
    same cells (the tilted rig, so every term is nonzero)."""
    l2c, c2i = _calib(2, tilt=0.05)
    geo = P.polar_geometry(t(l2c), t(c2i), IMG, None, grid_size=GRID, pc_range=PC,
                           w_fine=IMG[1] // 4, zeta_bins=64, near_columns=8)
    m = np.einsum("bij,bjk->bik", c2i, l2c)
    assert_close(geo.u_cell[0, 3, 5], JP._project_uv_zeta(
        jnp.asarray(m[0]), PC[0] + 5.5 * 0.4, PC[1] + 3.5 * (25.6 / 48), 0.5 * (PC[2] + PC[5]))[0],
        atol=1e-4, rtol=1e-6)
    assert geo.near_uv.shape == (2, GRID[1], 8, GRID[2], 2)
    assert geo.far_coords.shape == (2, GRID[1], GRID[0] - 8, 2)
    assert bool((geo.far_coords.abs() <= 1.0).all())


# --------------------------------------------------------- polar_image_bev


def _jax_init(jm, feats, l2c, c2i, bda):
    return jax.jit(lambda fs: jm.init(KEY, fs, l2c, c2i, bda, False))(feats)


@pytest.mark.parametrize("name", ["axis_aligned", "tilted", "bev_aug", "no_near"])
def test_polar_image_bev_eval_matches_jax(name):
    jm, feats, l2c, c2i, bda = _case(name)
    v = perturb_variables(_jax_init(jm, feats, l2c, c2i, bda), seed=3)
    ref = np.asarray(jax.jit(lambda vv, fs: jm.apply(vv, fs, l2c, c2i, bda, False))(v, feats))
    f2v, collapse = (m.eval() for m in _port_pair(v))
    with torch.no_grad():
        got = _port_bev(f2v, collapse, [t(f) for f in feats], l2c, c2i, bda, jm)
    assert got.shape == ref.shape == (2, GRID[1], GRID[0], BEVC)
    assert_close(got, ref, atol=BEV_TOL * float(np.abs(ref).max()))


def _param_grads(variables, grads):
    p = {"f2v": weights.frustum_to_voxel(grads["f2v"], variables["batch_stats"]["f2v"]),
         "map_to_bev": weights.conv2d_collapse(grads["map_to_bev"],
                                               variables["batch_stats"]["map_to_bev"])}
    return {k: v.numpy() for sd in p.values() for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def test_polar_image_bev_train_matches_jax():
    """Train mode: the output, both BNs' updated statistics (the f2v BN's from
    one joint call over the slab and the near field) and the gradients of a
    random output cotangent with respect to the reduce kernel and bias, both
    BNs' affine parameters, the collapse kernel and the feature maps."""
    jm, feats, l2c, c2i, bda = _case("tilted")
    v = perturb_variables(_jax_init(jm, feats, l2c, c2i, bda), seed=4)

    @jax.jit
    def jax_side(params, fs, cot):
        def fwd(pp, ff):
            out, new = jm.apply({"params": pp, "batch_stats": v["batch_stats"]}, ff, l2c, c2i,
                                bda, True, mutable=["batch_stats"])
            return out, new["batch_stats"]

        out, vjp_fn, stats = jax.vjp(fwd, params, fs, has_aux=True)
        return out, stats, vjp_fn(cot)

    cot = np.random.RandomState(5).randn(2, GRID[1], GRID[0], BEVC).astype(np.float32)
    out, new_stats, (g_params, g_feats) = jax_side(v["params"], feats, cot)

    f2v, collapse = (m.train() for m in _port_pair(v))
    x = [t(f).requires_grad_() for f in feats]
    got = _port_bev(f2v, collapse, x, l2c, c2i, bda, jm)
    assert_close(got, out, atol=BEV_TOL * float(np.abs(np.asarray(out)).max()))
    (got * t(cot)).sum().backward()

    new = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(np.asarray, new_stats)}
    f2v_ref, collapse_ref = _port_pair(new)
    for port, ref in ((f2v, f2v_ref), (collapse, collapse_ref)):
        ref_sd = ref.state_dict()
        for k, s in port.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                assert_close(s, ref_sd[k], atol=1e-6, rtol=1e-5, err_msg=k)
    ref_grads = _param_grads(v, g_params)
    named = {**{f"channel_reduce.{k}": p for k, p in f2v.channel_reduce.named_parameters()},
             **{f"block.{k}": p for k, p in collapse.block.named_parameters()}}
    assert set(named) == set(ref_grads)
    # the reduce bias feeds a train-mode BN, so its true gradient is 0 and
    # both sides return rounding noise: the largest gradient of all tensors
    # is the scale
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    for k, p in named.items():
        assert_close(p.grad, ref_grads[k], atol=GRAD_TOL * scale, rtol=GRAD_TOL, err_msg=k)
    for a, r in zip(x, g_feats):
        r = np.asarray(r)
        assert_close(a.grad, r, atol=GRAD_TOL * float(np.abs(r).max()), rtol=GRAD_TOL)


def test_polar_rejects_bad_zeta_bins():
    l2c, c2i = _calib(1)
    with pytest.raises(ValueError, match="zeta_bins"):
        P.polar_geometry(t(l2c), t(c2i), IMG, None, grid_size=GRID, pc_range=PC, w_fine=24,
                         zeta_bins=1)


# ---------------------------------------------------------------- detector


@pytest.fixture(scope="module")
def jax_polar():
    """The JAX TINY polar detector: its variables (BN statistics and affine
    parameters randomized), the batch, and its eval head outputs."""
    batch = make_tiny_batch(np.random.RandomState(0))
    model = JaxModel(cfg=TINY_POLAR)
    variables = jax.jit(lambda b: model.init(KEY, b, False))(batch)
    variables = perturb_variables(variables, seed=1)
    preds, _ = jax.jit(lambda v, b: model.apply(v, b, False, mutable=["batch_stats"]))(
        variables, batch)
    return model, variables, batch, {k: np.asarray(p) for k, p in preds.items()}


def test_polar_model_matches_jax(jax_polar):
    """Head outputs within HEAD_TOL; the occupancy, radar-only, bit-equal to
    the port's gather model on the same weights."""
    _, variables, batch, ref = jax_polar
    sd = from_jax_variables(variables)
    model = load(HGSFusionModel(port_config(TINY_POLAR), device="cpu"), sd)
    gather = load(HGSFusionModel(port_config(TINY, f2v_sampler_kernel="pallas"), device="cpu"),
                  sd)
    b = model.batch_to_device({k: np.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = model(b)
        occ = gather(b)["occupancy"]
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert_close(got[k], ref[k], atol=HEAD_TOL, rtol=HEAD_TOL, err_msg=k)
    assert torch.equal(got["occupancy"], occ)


def test_polar_state_dict_is_the_gather_models(jax_polar):
    polar = HGSFusionModel(port_config(TINY_POLAR), device="cpu")
    gather = HGSFusionModel(port_config(TINY, f2v_sampler_kernel="pallas"), device="cpu")
    assert list(polar.state_dict()) == list(gather.state_dict())
    for k, v in gather.state_dict().items():
        assert polar.state_dict()[k].shape == v.shape, k
    polar.load_state_dict(from_jax_variables(jax_polar[1]), strict=True)


def _port_step(variables, batch, perturb_seed=None):
    cfg = port_config(TINY_POLAR)
    model = load(HGSFusionModel(cfg, device="cpu"), from_jax_variables(variables))
    opt, lr_schedule = build_optimizer(dict(OPTIM_CFG), TOTAL_STEPS, model)
    cap = GradCapture(opt)
    step = make_train_step(model, TargetAssigner(cfg.anchor_generator, cfg.grid_size,
                                                 cfg.pc_range, cfg.class_names, device="cpu"),
                           cap, LOSS_WEIGHTS, cfg)
    pbatch = model.batch_to_device({k: np.asarray(v) for k, v in batch.items()})
    if perturb_seed is not None:
        pbatch = perturb_inputs(pbatch, perturb_seed)
    _, tb = step(pbatch)
    return step_record(model, cap, tb), float(lr_schedule(0))


TOTAL_STEPS = 20


def test_one_polar_step_matches_jax(jax_polar):
    """One TINY polar training step from the same parameters (the frozen
    backbone's residual scales at 0, as tests/test_torch_train.py): loss
    terms, gradients, updated parameters and BN statistics under
    ``train/step_compare.py``."""
    jmodel, variables, batch, _ = jax_polar
    variables = _zero_residual_scales(variables)
    tx, _ = jax_build_optimizer(OPTIM_CFG, total_steps=TOTAL_STEPS, params=variables["params"])
    tx = optax.chain(_capture(), tx)
    assigner = JaxAssigner(ANCHOR_CFG, TINY.grid_size, TINY.pc_range,
                           class_names=TINY.class_names)
    jstep = jax.jit(jax_make_train_step(jmodel, assigner, tx, LOSS_WEIGHTS, TINY_POLAR))
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=jax.jit(tx.init)(variables["params"]),
                       step=np.zeros((), np.int32))
    after, tb = jstep(state, batch)
    got, lr = _port_step(variables, batch)
    probes = [_port_step(variables, batch, seed)[0]["grads"] for seed in (1, 2)]
    ref = _jax_record(after, tb, list(got["grads"]))
    report = compare_steps(ref, got, sensitivity(got["grads"], probes), lr)
    print(f"polar step: {report}")


# ------------------------------------------------------------------ config


def test_vod_polar_preset_equals_yaml():
    port_yaml = model_config_from_yaml(load_config(YAML))
    assert vod_polar_config() == port_yaml
    assert (port_yaml.f2v_view, port_yaml.f2v_polar_zeta_bins,
            port_yaml.f2v_polar_near_columns) == ("polar", 128, 20)
    ref = dataclasses.replace(jax_model_config(jax_load_config(YAML)), compute_dtype="bfloat16")
    assert port_yaml == port_config(ref, **{
        f: getattr(port_yaml, f) for f in ("anchor_generator", "loss_weights", "score_thresh",
                                           "nms_thresh", "nms_pre_max_size",
                                           "nms_post_max_size", "optimization")})


@pytest.mark.parametrize("bad", [{"f2v_quant": "int8"}, {"f2v_sampler_kernel": "pallas"},
                                 {"use_depth": True}])
def test_polar_rejects_gather_only_options(bad):
    with pytest.raises(ValueError, match="polar"):
        HGSFusionModel(port_config(TINY_POLAR, **bad), device="cpu")
