"""PV-RCNN and PV-RCNN++ (``ops/pointnet2.py::farthest_point_sample``,
``models/pvrcnn.py``'s keypoint pieces, ``models/detector.py``'s
``PVRCNNModel`` and ``PVRCNNPlusPlusModel``, the ``pvrcnn`` family of
``train/trainer.py::make_twostage_train_step``) against the JAX package's,
on the CPU, f32, at the TINY cut of the two-stage test ((0, -8, -3, 16, 8,
2) at 0.5 x 0.5 x 0.125 m: 32 x 32 x 40 voxels, a 4 x 4 BEV map, 96
anchors, 8 RoIs, 32 keypoints, 128 points).

Farthest-point sampling returns JAX's indices exactly (FPS is chaotic: one
rounding difference moves every later keypoint), with invalid points,
point 0 invalid, duplicate points and more keypoints than valid points.
Module outputs are held within 1e-5 of their largest value:
``interpolate_bev`` (border-clamped taps, keypoints on and past the
border), the voxel set abstraction in both aggregations (its keypoints
equal), ``KeypointWeighting``, ``VectorPoolLocal`` (an empty ball among
its centres), the RoI-grid pool in both aggregations; the proposal-centric
keypoints equal JAX's (and the fall-back to every valid point where no
proposal is near); ``point_fg_loss`` and its gradient within 1e-5. In
train mode (the step's route) VectorPoolLocal and the vectorpool set
abstraction hold their outputs, BN statistics and parameter gradients
within 2e-5 of the largest. Each whole TINY model's eval forward holds the
RPN maps, the proposals, the keypoints and the second stage to JAX's, and
its detections to the JAX package's eval step on JAX's outputs. One
PV-RCNN step runs under ``train/step_compare.py`` from BN biases lifted by
4 (``lift_bn_biases``, as the other two-stage steps); PV-RCNN++'s step
shares every loss term, so it is held through PV-RCNN's step and the
train-mode module tests of what it adds. Both YAMLs' model configs equal
JAX's and build their family."""
import functools

import jax
import numpy as np
import pytest
import torch

from hgsfusion_tpu.config import load_config as jax_load_config
from hgsfusion_tpu.config import model_config_from_yaml as jax_model_config
from hgsfusion_tpu.models import pvrcnn as jpv
from hgsfusion_tpu.models.detector import HGSFusionConfig as JaxConfig
from hgsfusion_tpu.models.detector import PVRCNNModel as JaxPVRCNN
from hgsfusion_tpu.models.detector import PVRCNNPlusPlusModel as JaxPVRCNNPlusPlus
from hgsfusion_tpu.ops import pointnet2 as jpn
from hgsfusion_tpu.train.trainer import make_pvrcnn_eval_step
from hgsfusion_tpu.train.trainer import make_twostage_train_step as jax_twostage_step
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.config import load_config, model_config_from_yaml
from hgsfusion_tpu_torch.models import pvrcnn as pv
from hgsfusion_tpu_torch.models.detector import PVRCNNModel, PVRCNNPlusPlusModel
from hgsfusion_tpu_torch.models.registry import build_network, yaml_network_class
from hgsfusion_tpu_torch.ops import library
from hgsfusion_tpu_torch.ops import pointnet2 as pn
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
NUM_ROIS, NUM_KEYPOINTS, NUM_POINTS = 8, 32, 128
FAMILIES = {"pvrcnn": (JaxPVRCNN, PVRCNNModel), "pvrcnnpp": (JaxPVRCNNPlusPlus,
                                                              PVRCNNPlusPlusModel)}
# the weight seed of both models' forward and PV-RCNN's step: seeds 2, 4, 11
# and 14 move rcnn_cls by 4e-4-2e-3 between the frameworks in train mode
# (its train-mode BN over 8 RoIs amplifies f32 rounding), 6 by 1.3e-5
SEED = 6
YAMLS = {"configs/pvrcnn_vod.yaml": PVRCNNModel, "configs/pvrcnnpp_vod.yaml": PVRCNNPlusPlusModel}
POST = {"SCORE_THRESH": 0.0, "NMS_CONFIG": {"NMS_THRESH": 0.01, "NMS_PRE_MAXSIZE": 4096,
                                             "NMS_POST_MAXSIZE": 8}}


def _jax_cfg():
    return JaxConfig(pc_range=RANGE, voxel_size=VOXEL, num_anchors_per_location=6,
                     num_point_features=5, pv_num_rois=NUM_ROIS, pv_num_keypoints=NUM_KEYPOINTS)


def _port_cfg(**kw):
    return port_config(_jax_cfg(), anchor_generator=ANCHORS, loss_weights=SECOND_LOSS, **kw)


def _close(got, ref, tol=TOL, err_msg=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, atol=tol * max(np.abs(ref).max(), 1e-6), rtol=0,
                               err_msg=err_msg)


# ---- farthest-point sampling ------------------------------------------------------

@functools.cache
def _jax_fps(k):
    return jax.jit(jax.vmap(lambda x, v: jpn.farthest_point_sample(x, v, k)))


def _fps_case(case):
    """(xyz (B, N, 3), valid (B, N), k) of a named case."""
    rng = np.random.RandomState({"random": 0, "invalid": 1, "duplicates": 2, "short": 3,
                                 "none_valid": 4, "wide": 5}[case])
    xyz = rng.uniform(-8, 8, (2, 160, 3)).astype(np.float32)
    valid = np.ones((2, 160), bool)
    k = 40
    if case == "invalid":  # a third invalid, point 0 of frame 0 among them
        valid = rng.rand(2, 160) > 0.33
        valid[0, 0] = False
    elif case == "duplicates":  # repeated points: exact distance ties
        xyz = np.repeat(rng.uniform(-8, 8, (2, 20, 3)), 8, axis=1).astype(np.float32)
        xyz = xyz[:, rng.permutation(160)]
    elif case == "short":  # more keypoints than valid points
        valid[:, 25:] = False
        valid[1, 10:] = False
    elif case == "none_valid":
        valid[1] = False
    elif case == "wide":  # metres apart over a 51 m range, the VoD scale
        xyz = (rng.uniform(0, 1, (2, 160, 3)) * [51.2, 51.2, 5] + [0, -25.6, -3]).astype(
            np.float32)
        k = 64
    return xyz, valid, k


@pytest.mark.parametrize("case", ["random", "invalid", "duplicates", "short", "none_valid",
                                  "wide"])
def test_farthest_point_sample_equals_jax(case):
    """The port's indices (the op's CPU route, the plain loop) equal JAX's
    for each frame, and the plain version alone equals the op."""
    xyz, valid, k = _fps_case(case)
    ref = np.asarray(_jax_fps(k)(xyz, valid))
    got = pn.farthest_point_sample(t(xyz), t(valid), k)
    assert got.dtype == torch.int64 and got.shape == (2, k)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(pn.farthest_point_sample_plain(t(xyz), t(valid), k).numpy(),
                                  ref)
    assert (got[:, 0] == 0).all()


# frame sizes across fps_plan's thresholds: one block, a cluster of 2, of
# 4 and 8, the full cluster of 16 at 16 points a thread, then 32
PLAN_SIZES = (1, 700, 2048, 2049, 8192, 16384, 32768, 32769, library.FPS_MAX_POINTS)


@pytest.mark.parametrize("n", PLAN_SIZES)
def test_fps_plan_covers_the_frame(n):
    """The FPS kernel's plan: every point in one block of at most 16, no
    block empty, a power of 2 of points a thread; 8,192 points on a cluster
    of 4, 16,384 on 8; a frame above the limit refused."""
    cluster, pts = library.fps_plan(n)
    block = library.FPS_THREADS * pts
    assert 1 <= cluster <= library.FPS_MAX_CLUSTER and pts in (1, 2, 4, 8, 16, 32)
    assert (cluster - 1) * block < n <= cluster * block
    assert library.fps_plan(8192) == (4, 16) and library.fps_plan(16384) == (8, 16)
    with pytest.raises(ValueError, match=f"at most {library.FPS_MAX_POINTS}"):
        library.fps_plan(library.FPS_MAX_POINTS + 1)


def _fps_by_records(xyz, valid, k):
    """``csrc/fps.cu``'s selection under ``fps_plan`` in PyTorch: each
    warp's record (the largest 32-bit key, bits(d) + 1 for d >= 0 and 0
    else, then the lowest index of its 32 * pts points), then the records'
    largest key, then the lowest slot; the frame padded to the cluster's
    points with -inf."""
    b, n = valid.shape
    cluster, pts = library.fps_plan(n)
    pad = cluster * library.FPS_THREADS * pts - n
    xyz = torch.nn.functional.pad(xyz, (0, 0, 0, pad))
    dist = torch.nn.functional.pad(torch.where(valid, 1e10, -1.0), (0, pad), value=-np.inf)
    rows = torch.arange(b)
    idx = torch.zeros((b, k), dtype=torch.int64)
    last = xyz[:, 0]
    for i in range(1, k):
        d = xyz - last[:, None]
        dist = torch.minimum(dist, (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                             + d[..., 2] * d[..., 2])
        key = torch.where(dist >= 0, dist.view(torch.int32).long() + 1, 0).view(b, -1, 32 * pts)
        lane = key.argmax(-1)
        slot = key.gather(-1, lane[..., None])[..., 0].argmax(-1)
        idx[:, i] = slot * 32 * pts + lane[rows, slot]
        last = xyz[rows, idx[:, i]]
    return idx


@pytest.mark.parametrize("n", PLAN_SIZES[1:-1])
def test_fps_records_equal_jax(n):
    """The kernel's two-level selection (warp records, then the cluster's
    slots) over ``fps_plan``'s blocks gives JAX's indices at frame sizes
    across its thresholds: a third of the points invalid, point 0 among
    them, exact duplicates in different blocks, more keypoints than the 10
    valid points of the second frame."""
    rng = np.random.RandomState(n)
    xyz = np.repeat(rng.uniform(-20, 20, (2, -(-n // 4), 3)), 4, axis=1)[:, :n].astype(np.float32)
    xyz = xyz[:, rng.permutation(n)]
    valid = rng.rand(2, n) > 0.33
    valid[0, 0] = False
    valid[1] = False
    valid[1, rng.choice(n, min(n, 10), replace=False)] = True
    k = 24
    ref = np.asarray(_jax_fps(k)(xyz, valid))
    np.testing.assert_array_equal(_fps_by_records(t(xyz), t(valid), k).numpy(), ref)


def test_chunked_dense_ball_query_equals_one_chunk():
    """``ball_query`` a few centres at a time equals it in one chunk."""
    rng = np.random.RandomState(6)
    xyz, new_xyz = rng.uniform(-2, 2, (200, 3)), rng.uniform(-2, 2, (50, 3))
    valid = rng.rand(200) > 0.2
    one = pn.ball_query(t(new_xyz), t(xyz), t(valid), 0.8, 16)
    chunked = pn.ball_query(t(new_xyz), t(xyz), t(valid), 0.8, 16, chunk=7)
    for a, b in zip(one, chunked):
        assert torch.equal(a, b)


# ---- modules -----------------------------------------------------------------------

def test_interpolate_bev_matches_jax():
    """Keypoints inside, on the border of and past a 6 x 5 map at stride 8:
    border-clamped taps, no half-texel shift."""
    rng = np.random.RandomState(7)
    bev = rng.randn(2, 6, 5, 4).astype(np.float32)
    xy = np.concatenate([rng.uniform(-4, 24, (2, 12, 1)), rng.uniform(-12, 20, (2, 12, 1))],
                        axis=-1).astype(np.float32)
    xy[:, 0] = [0.0, -8.0]  # the map's first corner
    xy[:, 1] = [20.0, 16.0]  # the far corner, past the last cell's centre
    ref = jax.jit(lambda b, p: jpv.interpolate_bev(b, p, RANGE, VOXEL, 8))(bev, xy)
    _close(pv.interpolate_bev(t(bev), t(xy), RANGE, VOXEL, 8), ref)


def _stages(seed=5):
    """x_conv3 and x_conv4 of the TINY grid (strides 4 and 8), a third of
    the cells active, 64 channels each."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape, ds in (("x_conv3", (11, 8, 8), 4), ("x_conv4", (5, 4, 4), 8)):
        mask = rng.rand(1, *shape, 1) < 0.33
        out[name] = ((rng.randn(1, *shape, 64) * mask).astype(np.float32), mask, ds)
    return out


def _port_stages(stages):
    return {k: (t(f), t(m), ds) for k, (f, m, ds) in stages.items()}


def _vsa_inputs(seed=8):
    b = _batch(seed, n=NUM_POINTS)
    bev = np.random.RandomState(seed).randn(1, 4, 4, 16).astype(np.float32)
    rois = np.array([[[4, -2, -0.5, 3.9, 1.6, 1.56, 0.3], [10, 3, -0.8, 0.8, 0.6, 1.73, -1.0],
                      [60, 0, 0, 1, 1, 1, 0]]], np.float32)
    return b["points"], b["points_valid"], bev, rois, np.array([[True, True, False]])


def _vsa(aggregation, centric):
    """The JAX VSA module, its variables and a runner over the inputs."""
    points, valid, bev, rois, roi_valid = _vsa_inputs()
    stages = _stages()
    module = jpv.VoxelSetAbstraction(num_keypoints=NUM_KEYPOINTS, pc_range=RANGE,
                                     voxel_size=VOXEL, aggregation=aggregation)
    extra = (rois, roi_valid) if centric else ()
    variables = shaped_variables(module, points, valid, bev, stages, False, *extra, seed=9)
    port = pv.VoxelSetAbstraction(2, 16, {"x_conv3": 64, "x_conv4": 64}, NUM_KEYPOINTS, RANGE,
                                  VOXEL, aggregation=aggregation)
    port.load_state_dict(weights.linear_bn_stack(variables["params"], variables["batch_stats"]))
    inputs = (points, valid, bev, stages, extra)
    return module, variables, port, inputs


@pytest.mark.parametrize("aggregation,centric", [("sa", False), ("vectorpool", True)])
def test_voxel_set_abstraction_matches_jax(aggregation, centric):
    """Eval mode: PV-RCNN's (FPS keypoints, SA) and PV-RCNN++'s
    (proposal-centric keypoints, VectorPool; one proposal not valid): the
    keypoints equal, the fused features within 1e-5 of the largest."""
    module, variables, port, (points, valid, bev, stages, extra) = _vsa(aggregation, centric)
    ref_kp, ref = jax.jit(lambda v, p, m, b, *e: module.apply(v, p, m, b, stages, False, *e))(
        variables, points, valid, bev, *extra)
    with torch.no_grad():
        kp, got = port.eval()(t(points), t(valid), t(bev), _port_stages(stages),
                              *(t(e) for e in extra))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(ref_kp))
    assert got.shape == (1, NUM_KEYPOINTS, 128)
    _close(got, ref)


def test_keypoint_weighting_matches_jax():
    rng = np.random.RandomState(10)
    feats = rng.randn(2, 12, 128).astype(np.float32)
    module = jpv.KeypointWeighting()
    variables = shaped_variables(module, feats, False, seed=11)
    ref_f, ref_l = jax.jit(lambda v, f: module.apply(v, f, False))(variables, feats)
    port = pv.KeypointWeighting(128)
    port.load_state_dict(weights.linear_bn_stack(variables["params"], variables["batch_stats"]))
    with torch.no_grad():
        got_f, got_l = port.eval()(t(feats))
    _close(got_f, ref_f)
    _close(got_l, ref_l)


def _vp_inputs(seed=12):
    """Centres over 60 points (a fifth invalid), the last centre far from
    every point (an empty ball)."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-2, 2, (2, 60, 3)).astype(np.float32)
    feats = rng.randn(2, 60, 6).astype(np.float32)
    valid = rng.rand(2, 60) > 0.2
    centres = np.concatenate([rng.uniform(-2, 2, (2, 9, 3)), np.full((2, 1, 3), 9.0)],
                             axis=1).astype(np.float32)
    return centres, xyz, feats, valid


def test_vector_pool_local_matches_jax():
    """Eval mode, radius 1.2 (cells fed by several slots, some by none), an
    empty ball: within 1e-5 of the largest, the empty ball's row the BN's
    image of zeros."""
    centres, xyz, feats, valid = _vp_inputs()
    module = jpv.VectorPoolLocal(radius=1.2, out_channels=16)
    variables = shaped_variables(module, centres, xyz, feats, valid, False, seed=13)
    ref = jax.jit(lambda v, *a: module.apply(v, *a, False))(variables, centres, xyz, feats,
                                                             valid)
    port = pv.VectorPoolLocal(6, 1.2, 16)
    port.load_state_dict(weights.linear_bn_stack(variables["params"], variables["batch_stats"]))
    with torch.no_grad():
        pooled = port.pool(t(centres[0]), t(xyz[0]), t(feats[0]), t(valid[0]))
        got = port.eval()(t(centres), t(xyz), t(feats), t(valid))
    _close(got, ref)
    assert (pooled[-1] == 0).all() and (pooled[:-1] != 0).any()


@pytest.mark.parametrize("aggregation", ["sa", "vectorpool"])
def test_roi_grid_pool_matches_jax(aggregation):
    """Eval mode: 3 RoIs' 6^3 grid points over 24 keypoints (128 wide)."""
    rng = np.random.RandomState(14)
    rois = np.array([[[4, -2, -0.5, 3.9, 1.6, 1.56, 0.3], [10, 3, -0.8, 0.8, 0.6, 1.73, -1.0],
                      [8, 0, -1, 5, 3, 2, 2.0]]], np.float32)
    keypoints = np.concatenate([rng.uniform(0, 14, (1, 24, 1)), rng.uniform(-5, 5, (1, 24, 1)),
                                rng.uniform(-2, 1, (1, 24, 1))], axis=-1).astype(np.float32)
    kp_feats = rng.randn(1, 24, 128).astype(np.float32)
    module = jpv.RoIGridPool(aggregation=aggregation)
    variables = shaped_variables(module, rois, keypoints, kp_feats, False, seed=15)
    ref = jax.jit(lambda v, *a: module.apply(v, *a, False))(variables, rois, keypoints, kp_feats)
    port = pv.RoIGridPool(128, aggregation=aggregation)
    port.load_state_dict(weights.linear_bn_stack(variables["params"], variables["batch_stats"]))
    with torch.no_grad():
        got = port.eval()(t(rois), t(keypoints), t(kp_feats))
    assert got.shape == (1, 3, 216, 128)
    _close(got, ref)


@pytest.mark.parametrize("near", [True, False])
def test_proposal_centric_keypoints_match_jax(near):
    """The points near a valid proposal (the invalid one ignored), or all
    valid points where no proposal is near: the keypoints equal JAX's."""
    points, valid, _, rois, roi_valid = _vsa_inputs(16)
    if not near:
        rois = rois + np.float32([40, 0, 0, 0, 0, 0, 0])
    ref = jax.jit(jax.vmap(lambda x, v, r, rv: jpv.sample_keypoints_proposal_centric(
        x, v, r, rv, NUM_KEYPOINTS)))(points[..., :3], valid, rois, roi_valid)
    got = pv.sample_keypoints_proposal_centric(t(points[..., :3]), t(valid), t(rois),
                                               t(roi_valid), NUM_KEYPOINTS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_point_fg_loss_matches_jax():
    """Keypoints in, near (the 0.2 m shell: ignored) and away from the gt
    boxes: the loss and its gradient in the logits within 1e-5."""
    gt = _batch()["gt_boxes"]
    rng = np.random.RandomState(17)
    near = gt[:, :2, None, :3] + rng.uniform(-1.2, 1.2, (1, 2, 10, 3))
    kp = np.concatenate([near.reshape(1, 20, 3), rng.uniform(0, 14, (1, 12, 3))],
                        axis=1).astype(np.float32)
    logits = rng.randn(1, kp.shape[1], 1).astype(np.float32)
    ref, ref_g = jax.jit(jax.value_and_grad(lambda lg: jpv.point_fg_loss(lg, kp, gt)))(logits)
    lt = t(logits).requires_grad_()
    got = pv.point_fg_loss(lt, t(kp), t(gt))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=TOL)
    _close(lt.grad, ref_g)


def _train_mode_grads(module, variables, jax_args, port, port_args):
    """JAX's and the port's train-mode outputs, BN statistics and
    parameter gradients of sum(out * w) for one random w (numpy)."""
    w = None

    def jax_loss(params):
        out, mut = module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                *jax_args, True, mutable=["batch_stats"])
        out = out[-1] if isinstance(out, tuple) else out
        return (out * w).sum(), (out, mut["batch_stats"])

    out = port.train()(*port_args)
    out = out[-1] if isinstance(out, tuple) else out
    w = np.random.RandomState(18).randn(*out.shape).astype(np.float32)
    (out * t(w)).sum().backward()
    (_, (ref, stats)), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        variables["params"])
    return out, ref, stats, grads


@pytest.mark.parametrize("name", ["vector_pool_local", "vsa_vectorpool"])
def test_vectorpool_train_mode_matches_jax(name):
    """PV-RCNN++'s additions in train mode: outputs, updated BN statistics
    and every parameter's gradient within 2e-5 of the largest."""
    if name == "vector_pool_local":
        centres, xyz, feats, valid = _vp_inputs()
        module = jpv.VectorPoolLocal(radius=1.2, out_channels=16)
        variables = shaped_variables(module, centres, xyz, feats, valid, False, seed=19)
        port = pv.VectorPoolLocal(6, 1.2, 16)
        jax_args = port_args = (centres, xyz, feats, valid)
        port_args = tuple(t(a) for a in port_args)
    else:
        module, variables, port, (points, valid, bev, stages, extra) = _vsa("vectorpool", True)
        jax_args = (points, valid, bev, stages)
        port_args = (t(points), t(valid), t(bev), _port_stages(stages))
        module = _CentricVSA(module, extra)
    port.load_state_dict(weights.linear_bn_stack(variables["params"], variables["batch_stats"]))
    out, ref, stats, grads = _train_mode_grads(module, variables, jax_args, port,
                                               _extra_args(port_args, name))
    _close(out, ref, TRAIN_TOL)
    want = weights.linear_bn_stack(grads, variables["batch_stats"])
    new_stats = weights.linear_bn_stack(variables["params"], stats)
    for k, p in port.named_parameters():
        _close(p.grad, want[k].numpy(), TRAIN_TOL, err_msg=k)
    for k, v in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _close(v, new_stats[k].numpy(), TRAIN_TOL, err_msg=k)


class _CentricVSA:
    """A JAX VSA module whose ``apply`` passes the proposals after ``train``."""

    def __init__(self, module, extra):
        self.module, self.extra = module, extra

    def apply(self, variables, *args, **kw):
        *inputs, train = args
        return self.module.apply(variables, *inputs, train, *self.extra, **kw)


def _extra_args(port_args, name):
    if name == "vector_pool_local":
        return port_args
    _, _, _, rois, roi_valid = _vsa_inputs()
    return port_args + (t(rois), t(roi_valid))


# ---- the models ----------------------------------------------------------------

def _jax_batch(cfg):
    return {**_batch(n=NUM_POINTS), "anchors": _assigner(cfg).flat_anchors}


@pytest.mark.parametrize("name", ["pvrcnn", "pvrcnnpp"])
def test_model_forward_matches_jax(name):
    """Eval-mode forward from the same weights: the RPN's maps and the second
    stage within 1e-5 of the largest, the proposals within 1e-6, the
    keypoints equal; the detections (``refine_post_process``) equal the
    JAX package's eval step on JAX's outputs (valid slots and labels
    equal, boxes and scores within 1e-5)."""
    cfg = _jax_cfg()
    model = FAMILIES[name][0](cfg=cfg)
    batch = _jax_batch(cfg)
    variables = shaped_variables(model, batch, False, seed=SEED)
    ref = jax.jit(lambda v, b: model.apply(v, b, False))(variables, batch)
    port = load(FAMILIES[name][1](_port_cfg(nms_post_max_size=8, score_thresh=0.0), device="cpu"),
                from_jax_variables(variables))
    with torch.no_grad():
        got = port(port.batch_to_device(batch))
        dets = port.post_process(got)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["keypoints"].numpy(), np.asarray(ref["keypoints"]))
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


def test_one_step_matches_jax():
    """One PV-RCNN step from the same weights (BN biases lifted by 4): loss
    terms (point_fg among them), gradients, updated parameters and BN
    statistics (``compare_one_step``)."""
    cfg = _jax_cfg()
    model = JaxPVRCNN(cfg=cfg)
    variables = lift_bn_biases(shaped_variables(model, _jax_batch(cfg), False, seed=SEED),
                               BN_LIFT)
    assigner = _assigner(cfg)

    def jax_make(tx):
        return jax_twostage_step(model, assigner, tx, dict(SECOND_LOSS), cfg, family="pvrcnn")
    pcfg = _port_cfg()

    def port_step(m, opt):
        return make_train_step_for_cfg(m, opt, pcfg)[1]

    report = compare_one_step(variables, jax_make, lambda: PVRCNNModel(pcfg, device="cpu"),
                              port_step, _batch(n=NUM_POINTS), OPTIM_CFG)
    print(report)


# ---- the YAMLs -----------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(YAMLS))
def test_yaml_config_and_family(path):
    """Each YAML's family, and its model config equal to the JAX package's
    on every field they share (1,024 keypoints, 128 RoIs)."""
    cfg = load_config(path)
    assert yaml_network_class(cfg) is YAMLS[path]
    ref = jax_model_config(jax_load_config(path))
    got = model_config_from_yaml(cfg)
    assert got == port_config(ref, **{f: getattr(got, f) for f in PORT_ONLY})
    assert got.pv_num_keypoints == 1024 and got.pv_num_rois == 128
    assert isinstance(build_network(cfg, _port_cfg(), device="cpu"), YAMLS[path])
