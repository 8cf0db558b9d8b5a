"""Part-A2 (``models/parta2.py``, ``ops/roiaware_pool.py``,
``models/detector.py::PartA2Model``, the ``parta2`` family of
``train/trainer.py::make_twostage_train_step``) against the JAX package's,
on the CPU, f32, at the TINY cut of JAX's two-stage zoo test ((0, -8, -3,
16, 8, 2) at 0.5 x 0.5 x 0.125 m: 32 x 32 x 40 voxels, 41 planes, 8 RoIs,
a 4^3 RoI-aware pool, 512 points).

The nearest upsampling's source indices equal JAX's at the stages' shapes
at full width and at TINY, and its gradient JAX's VJP. Module outputs are
held within 1e-5 of their largest value: the UNet decoder (eval; in train
mode its outputs, BN statistics and parameter gradients within 2e-5),
``PointPartHead``, the RoI-aware pools (max and mean at out sizes 4 and 6,
rotated, empty and invalid RoIs, invalid points; the max equal to JAX's
bit for bit), and ``PartA2RoIHead`` in train mode (2e-5, the point
features' gradient among them). The points' gathered voxel features equal
JAX's. The max pool's gradient with tied points (several points of one
voxel carry the same features) equals JAX's ``segment_max`` VJP within
1e-6: the cotangent split evenly among the ties. ``part_targets`` (shell
points, padded slots, two overlapping boxes) and ``part_head_loss`` with
its gradient within 1e-5. The TINY model's eval forward holds the RPN
maps, the proposals, the point head and the second stage to JAX's, its
detections to JAX's eval step; one step runs under ``train/step_compare.py``
from BN biases lifted by 4. The JAX variables and the model come from one
module-scoped fixture."""
import jax
import numpy as np
import pytest
import torch

from hgsfusion_tpu.config import load_config as jax_load_config
from hgsfusion_tpu.config import model_config_from_yaml as jax_model_config
from hgsfusion_tpu.models import parta2 as jpa
from hgsfusion_tpu.models.detector import HGSFusionConfig as JaxConfig
from hgsfusion_tpu.models.detector import PartA2Model as JaxPartA2
from hgsfusion_tpu.ops import roiaware_pool as jrp
from hgsfusion_tpu.train.trainer import make_pvrcnn_eval_step
from hgsfusion_tpu.train.trainer import make_twostage_train_step as jax_twostage_step
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.config import load_config, model_config_from_yaml
from hgsfusion_tpu_torch.models import parta2 as pa
from hgsfusion_tpu_torch.models.detector import PartA2Model
from hgsfusion_tpu_torch.models.registry import build_network, yaml_network_class
from hgsfusion_tpu_torch.ops import roiaware_pool as rp
from hgsfusion_tpu_torch.train.trainer import make_train_step_for_cfg
from hgsfusion_tpu_torch.weights import from_jax_variables
from test_torch_center_families import ANCHORS, PORT_ONLY, RANGE, SECOND_LOSS, _batch
from test_torch_twostage import _FixedPreds, _assigner
from test_train import OPTIM_CFG
from torch_parity import (compare_one_step, lift_bn_biases, load,  # noqa: F401
                          one_torch_thread, port_config, shaped_variables, t)

TOL = 1e-5
TRAIN_TOL = 2e-5
BN_LIFT = 4.0
VOXEL = (0.5, 0.5, 0.125)
# 512 points over the TINY range: the proposals' RoI-aware grids hold
# about 10 points (128 leave them all but empty)
NUM_ROIS, POOL, NUM_POINTS = 8, 4, 512
# the weight seed of the model's forward and step, and the scale of the
# RPN's box kernel (``_near_anchors``)
SEED, BOX_SCALE = 0, np.float32(0.01)
POST = {"SCORE_THRESH": 0.0, "NMS_CONFIG": {"NMS_THRESH": 0.01, "NMS_PRE_MAXSIZE": 4096,
                                             "NMS_POST_MAXSIZE": 8}}
# the stride-1 .. stride-8 (D, H, W) of VoxelBackBone8x at full width
# (320 x 320 x 50 voxels: 51 planes) and at TINY (41 planes)
STAGE_SHAPES = {"full": ((51, 320, 320), (26, 160, 160), (13, 80, 80), (6, 40, 40)),
                "tiny": ((41, 32, 32), (21, 16, 16), (11, 8, 8), (5, 4, 4))}
STAGE_CHANNELS = (16, 32, 64, 64)


def _jax_cfg():
    return JaxConfig(pc_range=RANGE, voxel_size=VOXEL, num_anchors_per_location=6,
                     num_point_features=5, pv_num_rois=NUM_ROIS, parta2_pool_size=POOL)


def _port_cfg(**kw):
    return port_config(_jax_cfg(), anchor_generator=ANCHORS, loss_weights=SECOND_LOSS, **kw)


def _close(got, ref, tol=TOL, err_msg=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, atol=tol * max(np.abs(ref).max(), 1e-6), rtol=0,
                               err_msg=err_msg)


# ---- the decoder ---------------------------------------------------------------

@pytest.mark.parametrize("cut", sorted(STAGE_SHAPES))
def test_upsample_indices_match_jax(cut):
    """Each decoder level's source index on each axis, coarser stage to
    finer, equals JAX's ``_upsample_to`` (an index ramp upsampled)."""
    shapes = STAGE_SHAPES[cut]
    pairs = [(coarse[axis], fine[axis], axis) for fine, coarse in zip(shapes[:-1], shapes[1:])
             for axis in range(3)]

    def ramps():  # every pair's ramp upsampled, in one jitted call
        return [jpa._upsample_to(jax.numpy.arange(s, dtype=np.float32).reshape(
            [1] + [s if a == axis else 1 for a in range(3)] + [1]),
            tuple(tgt if a == axis else 1 for a in range(3))) for s, tgt, axis in pairs]

    for (s, tgt, _), ref in zip(pairs, jax.jit(ramps)()):
        np.testing.assert_array_equal(pa.upsample_index(s, tgt, "cpu").numpy(),
                                      np.asarray(ref).reshape(-1).astype(np.int64))


def test_upsample_values_and_gradient_match_jax():
    """x_conv4 -> x_conv3 at TINY and an odd case (3 -> 8, runs of 2 and
    3): the values equal, the gradient JAX's VJP within 1e-6."""
    rng = np.random.RandomState(0)
    for src_dhw, tgt in (((5, 4, 4), (11, 8, 8)), ((3, 2, 3), (8, 5, 7))):
        src = rng.randn(2, *src_dhw, 3).astype(np.float32)
        ct = rng.randn(2, *tgt, 3).astype(np.float32)
        ref, ref_grad = jax.jit(lambda x, c: _value_and_vjp(
            lambda y: jpa._upsample_to(y, tgt), x, c))(src, ct)
        x = t(src).requires_grad_()
        out = pa.upsample_to(x, tgt)
        out.backward(t(ct))
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
        _close(x.grad, ref_grad, 1e-6)


def _value_and_vjp(fn, x, ct):
    """fn(x) and the VJP of ``ct`` (to jit together)."""
    out, vjp = jax.vjp(fn, x)
    return out, vjp(ct)[0]


def _stages(seed=1):
    """VoxelBackBone8x's four stages at TINY, about a third of each stage's
    sites active (JAX arrays: the decoder indexes them by traced indices)."""
    rng = np.random.RandomState(seed)
    out = {}
    for i, (shape, c) in enumerate(zip(STAGE_SHAPES["tiny"], STAGE_CHANNELS), start=1):
        mask = rng.rand(1, *shape, 1) < 0.33
        out[f"x_conv{i}"] = (jax.numpy.asarray((rng.randn(1, *shape, c) * mask).astype(
            np.float32)), jax.numpy.asarray(mask), 2 ** (i - 1))
    return out


def _port_stages(stages):
    return {k: (t(f), t(m), ds) for k, (f, m, ds) in stages.items()}


def _decoder_weights(variables):
    return weights.unet_decoder(variables["params"], variables["batch_stats"])


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_unet_decoder_matches_jax(mode):
    """The stride-1 features (B, 41, 32, 32, 16) and their mask; in train
    mode also every BN's updated statistics and each parameter's gradient
    of sum(out * w)."""
    stages = _stages()
    module = jpa.UNetDecoder()
    variables = shaped_variables(module, stages, False, seed=2)
    port = pa.UNetDecoder()
    port.load_state_dict(_decoder_weights(variables))
    if mode == "eval":
        ref, ref_mask = jax.jit(lambda v: module.apply(v, stages, False))(variables)
        with torch.no_grad():
            got, mask = port.eval()(_port_stages(stages))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
        assert got.shape == (1, 41, 32, 32, 16)
        _close(got, ref)
        return
    w = np.random.RandomState(3).randn(1, 41, 32, 32, 16).astype(np.float32)

    def jax_loss(params):
        (out, _), mut = module.apply({"params": params,
                                      "batch_stats": variables["batch_stats"]}, stages, True,
                                     mutable=["batch_stats"])
        return (out * w).sum(), (out, mut["batch_stats"])

    (_, (ref, stats)), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        variables["params"])
    got, _ = port.train()(_port_stages(stages))
    (got * t(w)).sum().backward()
    _close(got, ref, TRAIN_TOL)
    want = weights.unet_decoder(grads, variables["batch_stats"])
    new_stats = weights.unet_decoder(variables["params"], stats)
    for k, p in port.named_parameters():
        _close(p.grad, want[k].numpy(), TRAIN_TOL, err_msg=k)
    for k, v in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _close(v, new_stats[k].numpy(), TRAIN_TOL, err_msg=k)


def test_gather_point_voxel_features_match_jax():
    """Points inside the grid, outside it (each axis, both sides) and
    invalid: the gathered stride-1 features equal JAX's, 0 where the point
    is out of the grid or invalid."""
    rng = np.random.RandomState(4)
    voxels = rng.randn(2, 41, 32, 32, 4).astype(np.float32)
    pts = np.stack([rng.uniform(-2, 18, (2, 60)), rng.uniform(-10, 10, (2, 60)),
                    rng.uniform(-4, 3, (2, 60))], axis=-1).astype(np.float32)
    valid = rng.rand(2, 60) > 0.2
    grid = _jax_cfg().grid_size
    ref = jax.jit(lambda vx, p, v: jpa.gather_point_voxel_features(vx, p, v, RANGE, VOXEL,
                                                                   grid))(voxels, pts, valid)
    got = pa.gather_point_voxel_features(t(voxels), t(pts), t(valid), RANGE, VOXEL, grid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = np.asarray(ref)
    assert (ref == 0).all(-1).any() and (ref != 0).any(-1).any()


def test_point_part_head_matches_jax():
    rng = np.random.RandomState(5)
    feats = rng.randn(2, 40, 16).astype(np.float32)
    module = jpa.PointPartHead(num_class=3)
    variables = shaped_variables(module, feats, False, seed=6)
    ref = jax.jit(lambda v, f: module.apply(v, f, False))(variables, feats)
    port = pa.PointPartHead(16, 3)
    port.load_state_dict(weights.linear_bn_stack(variables["params"], variables["batch_stats"]))
    with torch.no_grad():
        got = port.eval()(t(feats))
    for g, r in zip(got, ref):
        _close(g, r)


# ---- the RoI-aware pool ----------------------------------------------------------

def _pool_inputs(seed=7, n=96, c=5):
    """Two frames: RoIs rotated, one far from every point (empty), one all
    zeros (an invalid slot); a fifth of the points invalid, a third of
    them near the first two RoIs' centres."""
    rng = np.random.RandomState(seed)
    rois = np.array([[[4, -2, -0.5, 3.9, 1.6, 1.56, 0.3], [10, 3, -0.8, 2.8, 2.6, 1.73, -1.0],
                      [40, 0, 0, 2, 2, 2, 0.0], [0] * 7],
                     [[6, 1, -1, 5, 3, 2, 2.0], [2, -4, 0, 2, 4, 1.5, -2.5],
                      [3, 3, -1, 1, 1, 1, 0.7], [0] * 7]], np.float32)
    near = rois[:, :2, None, :3] + rng.uniform(-1.6, 1.6, (2, 2, n // 6, 3))
    far = np.stack([rng.uniform(0, 14, (2, n - n // 3)), rng.uniform(-7, 7, (2, n - n // 3)),
                    rng.uniform(-2.5, 1.5, (2, n - n // 3))], axis=-1)
    pts = np.concatenate([near.reshape(2, -1, 3), far], axis=1).astype(np.float32)
    feats = rng.randn(2, n, c).astype(np.float32)
    return rois, pts, feats, rng.rand(2, n) > 0.2


def _jax_pool(rois, pts, feats, valid, out_size, method):
    return jax.jit(jax.vmap(lambda r, p, f, v: jrp.roiaware_pool3d(
        r, p, f, v, out_size=out_size, pool_method=method)))(rois, pts, feats, valid)


@pytest.mark.parametrize("method,out_size", [("max", 4), ("max", 6), ("avg", 4), ("avg", 6)])
def test_roiaware_pool_matches_jax(method, out_size):
    """The max pool equal to JAX's bit for bit, the mean within 1e-6 of
    the largest; the empty and invalid RoIs all 0, some cells filled."""
    rois, pts, feats, valid = _pool_inputs()
    ref = np.asarray(_jax_pool(rois, pts, feats, valid, out_size, method))
    got = rp.roiaware_pool3d(t(rois), t(pts), t(feats), t(valid), out_size, method)
    assert got.shape == ref.shape == (2, 4, out_size, out_size, out_size, 5)
    if method == "max":
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        _close(got, ref, 1e-6)
    assert (ref[0, 2:] == 0).all() and (ref[:, 3] == 0).all() and (ref[:, :2] != 0).any()


def test_max_pool_gradient_with_ties_matches_jax():
    """Each point repeated three times with its features (the points of
    one voxel), a third of the features 0 (ReLU zeros): JAX's VJP splits a
    cell's cotangent evenly among the points equal to its max; the port's
    gradient equals it within 1e-6 of the largest."""
    rois, pts, feats, valid = _pool_inputs(seed=8, n=48, c=4)
    feats = np.maximum(feats, 0.0)
    pts, feats, valid = (np.repeat(a, 3, axis=1) for a in (pts, feats, valid))
    ct = np.random.RandomState(9).randn(2, 4, POOL, POOL, POOL, 4).astype(np.float32)

    def jax_pool(f):
        return jax.vmap(lambda r, p, ff, v: jrp.roiaware_pool3d(r, p, ff, v, out_size=POOL))(
            rois, pts, f, valid)

    ref, want = jax.jit(lambda f, c: _value_and_vjp(jax_pool, f, c))(feats, ct)
    x = t(feats).requires_grad_()
    got = rp.roiaware_pool3d(t(rois), t(pts), x, t(valid), POOL, "max")
    got.backward(t(ct))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    want = np.asarray(want)
    _close(x.grad, want, 1e-6)
    # the premise: cells whose max several points share, and a split gradient
    assert (np.abs(want) > 0).any() and (np.abs(want[:, ::3]) < np.abs(want).max()).any()


# ---- targets and loss ------------------------------------------------------------

def _target_inputs():
    """Two boxes overlapping (the first wins), a padded gt slot; points
    inside each, in the overlap, in the 0.2 m shell, outside, and padded
    (invalid) slots."""
    gt = np.zeros((1, 3, 8), np.float32)
    gt[0, 0] = [4, -2, -0.5, 3.9, 1.6, 1.56, 0.3, 1]
    gt[0, 1] = [6, -1.2, -0.5, 2.0, 2.0, 1.8, -0.4, 3]
    rng = np.random.RandomState(10)
    inner = gt[0, :2, None, :3] + rng.uniform(-0.7, 0.7, (2, 12, 3)) * [1, 0.5, 0.5]
    local = np.array([[2.02, 0, 0], [0, 0.88, 0], [-2.03, 0.1, 0.2]])  # past the faces
    c, s = np.cos(gt[0, 0, 6]), np.sin(gt[0, 0, 6])
    shell = gt[0, 0, :3] + np.stack([local[:, 0] * c - local[:, 1] * s,
                                     local[:, 0] * s + local[:, 1] * c, local[:, 2]], -1)
    outside = np.stack([rng.uniform(8, 14, 10), rng.uniform(-7, 7, 10),
                        rng.uniform(-2, 1, 10)], axis=-1)
    pts = np.concatenate([inner.reshape(-1, 3), shell, outside])[None].astype(np.float32)
    valid = np.ones(pts.shape[:2], bool)
    valid[0, -4:] = False
    return pts, valid, gt


def test_part_targets_match_jax():
    pts, valid, gt = _target_inputs()
    ref = jax.jit(jpa.part_targets)(pts, valid, gt)
    got = pa.part_targets(t(pts), t(valid), t(gt))
    for k in ("cls", "fg"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    _close(got["part"], ref["part"], 1e-6)
    cls = got["cls"].numpy()[0]
    assert {-1, 0, 1, 3} <= set(cls.tolist()) and (cls[-4:] == -1).all()


def test_part_head_loss_matches_jax():
    """The loss terms (1e-5 relative) and the gradients of their sum in the
    logits and the part predictions (1e-5 of the largest)."""
    pts, valid, gt = _target_inputs()
    rng = np.random.RandomState(11)
    logits = rng.randn(1, pts.shape[1], 3).astype(np.float32)
    parts = rng.randn(1, pts.shape[1], 3).astype(np.float32)

    def jax_loss(lg, pp):
        total, tb = jpa.part_head_loss(lg, pp, jpa.part_targets(pts, valid, gt))
        return total, tb

    (ref, ref_tb), ref_g = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(
        logits, parts)
    lt, pt = t(logits).requires_grad_(), t(parts).requires_grad_()
    total, tb = pa.part_head_loss(lt, pt, pa.part_targets(t(pts), t(valid), t(gt)))
    total.backward()
    for k in ("part_cls", "part_reg"):
        np.testing.assert_allclose(float(tb[k].detach()), float(ref_tb[k]), rtol=TOL, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(ref), rtol=TOL)
    for g, r in zip((lt.grad, pt.grad), ref_g):
        _close(g, r)


# ---- the RoI head --------------------------------------------------------------

def test_roi_head_train_mode_matches_jax():
    """PartA2RoIHead in train mode (4^3 pool, a third of the segmentation
    scores under 0.3): cls and reg, every BN's updated statistics, each
    parameter's gradient and the point features' within 2e-5 of the
    largest."""
    rois, pts, feats, valid = _pool_inputs(seed=12, n=90, c=16)
    rng = np.random.RandomState(13)
    feats = np.maximum(feats, 0.0)
    scores = rng.uniform(0.1, 0.9, pts.shape[:2]).astype(np.float32)
    parts = rng.uniform(0, 1, pts.shape[:2] + (3,)).astype(np.float32)
    roi_valid = np.array([[True, True, True, False]] * 2)
    module = jpa.PartA2RoIHead(pool_size=POOL)
    args = (rois, roi_valid, pts, valid, feats, scores, parts)
    variables = shaped_variables(module, *args, False, seed=14)
    w_cls = rng.randn(2, 4).astype(np.float32)
    w_reg = rng.randn(2, 4, 7).astype(np.float32)

    def jax_loss(params, f):
        (cls, reg), mut = module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                       rois, roi_valid, pts, valid, f, scores, parts, True,
                                       mutable=["batch_stats"])
        return (cls * w_cls).sum() + (reg * w_reg).sum(), (cls, reg, mut["batch_stats"])

    (_, (ref_cls, ref_reg, stats)), (grads, g_feats) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(variables["params"], feats)
    port = pa.PartA2RoIHead(16, POOL)
    port.load_state_dict(weights.linear_bn_stack(variables["params"], variables["batch_stats"]))
    ft = t(feats).requires_grad_()
    cls, reg = port.train()(t(rois), t(pts), t(valid), ft, t(scores), t(parts))
    ((cls * t(w_cls)).sum() + (reg * t(w_reg)).sum()).backward()
    _close(cls, ref_cls, TRAIN_TOL)
    _close(reg, ref_reg, TRAIN_TOL)
    _close(ft.grad, g_feats, TRAIN_TOL)
    want = weights.linear_bn_stack(grads, variables["batch_stats"])
    new_stats = weights.linear_bn_stack(variables["params"], stats)
    for k, p in port.named_parameters():
        _close(p.grad, want[k].numpy(), TRAIN_TOL, err_msg=k)
    for k, v in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _close(v, new_stats[k].numpy(), TRAIN_TOL, err_msg=k)


# ---- the model ----------------------------------------------------------------------

def _near_anchors(variables, scale: float = BOX_SCALE):
    """``variables`` with the RPN's box regression kernel scaled by
    ``scale``, so that the proposals stay near their anchors: random
    weights (BN biases lifted by 4 most of all) regress boxes metres to
    kilometres off, which hold no point, and the RoI head would pool
    nothing."""
    params = dict(variables["params"])
    head = dict(params["dense_head"])
    head["conv_box"] = {**head["conv_box"], "kernel": head["conv_box"]["kernel"] * scale}
    params["dense_head"] = head
    return {**variables, "params": params}


@pytest.fixture(scope="module")
def tiny():
    """The TINY JAX model, its config, a batch (with the anchors) and its
    variables from ``SEED`` (``shaped_variables``: traced once; the RPN's
    box kernel scaled by ``_near_anchors``)."""
    cfg = _jax_cfg()
    model = JaxPartA2(cfg=cfg)
    batch = {**_batch(n=NUM_POINTS), "anchors": _assigner(cfg).flat_anchors}
    return cfg, model, batch, _near_anchors(shaped_variables(model, batch, False, seed=SEED))


def test_model_forward_matches_jax(tiny):
    """Eval-mode forward from the same weights: the RPN maps, the point
    head and the second stage within 1e-5 of the largest, the proposals
    within 1e-6; the detections equal the JAX package's eval step on JAX's
    outputs (valid slots and labels equal, boxes and scores within 1e-5)."""
    cfg, model, batch, variables = tiny
    ref = jax.jit(lambda v, b: model.apply(v, b, False))(variables, batch)
    port = load(PartA2Model(_port_cfg(nms_post_max_size=8, score_thresh=0.0), device="cpu"),
                from_jax_variables(variables))
    with torch.no_grad():
        got = port(port.batch_to_device(batch))
        dets = port.post_process(got)
    assert set(got) == set(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        tol = 1e-6 if k in ("rois", "roi_scores") else TOL * max(np.abs(r).max(), 1e-6)
        np.testing.assert_allclose(got[k].numpy(), r, atol=tol, rtol=0, err_msg=k)
    assert int(got["roi_valid"].sum()) == NUM_ROIS
    preds = {k: np.asarray(v) for k, v in ref.items()}
    step = make_pvrcnn_eval_step(_FixedPreds(preds), _assigner(cfg), cfg, POST)
    want = jax.jit(lambda b: step({}, {}, b))(batch)
    for k in ("valid", "labels"):
        np.testing.assert_array_equal(dets[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(dets[k].numpy(), np.asarray(want[k]), atol=TOL, err_msg=k)
    assert int(dets["valid"].sum()) > 0


def test_one_step_matches_jax(tiny):
    """One step from the same weights (BN biases lifted by 4): loss terms
    (part_cls and part_reg among them), gradients, updated parameters and
    BN statistics (``compare_one_step``)."""
    cfg, model, batch, variables = tiny
    assigner = _assigner(cfg)

    def jax_make(tx):
        return jax_twostage_step(model, assigner, tx, dict(SECOND_LOSS), cfg, family="parta2")
    pcfg = _port_cfg()

    def port_step(m, opt):
        return make_train_step_for_cfg(m, opt, pcfg)[1]

    report = compare_one_step(lift_bn_biases(variables, BN_LIFT), jax_make,
                              lambda: PartA2Model(pcfg, device="cpu"), port_step,
                              {k: v for k, v in batch.items() if k != "anchors"}, OPTIM_CFG)
    print(report)


def test_yaml_config_and_family():
    """configs/parta2_vod.yaml: its family under both names, its model
    config equal to the JAX package's on every field they share (128 RoIs,
    a 6^3 pool)."""
    path = "configs/parta2_vod.yaml"
    cfg = load_config(path)
    assert yaml_network_class(cfg) is PartA2Model
    ref = jax_model_config(jax_load_config(path))
    got = model_config_from_yaml(cfg)
    assert got == port_config(ref, **{f: getattr(got, f) for f in PORT_ONLY})
    assert got.parta2_pool_size == 6 and got.pv_num_rois == 128
    for name in ("PartA2Net", "PartA2"):
        assert isinstance(build_network(name, _port_cfg(), device="cpu"), PartA2Model)
