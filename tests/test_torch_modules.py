"""Each ported module against its JAX counterpart, on the CPU, in f32.

JAX variables are initialized, their BatchNorm statistics and affine
parameters randomized, and carried to the port by ``hgsfusion_tpu_torch.
weights``. Tolerances are f32 round-off of the stated depth of arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgsfusion_tpu.models import layers as jl
from hgsfusion_tpu.models.anchor_head import AnchorHeadSingle as JaxHead
from hgsfusion_tpu.models.anchor_head import decode_selected_boxes as jax_decode
from hgsfusion_tpu.models.bev_encoder import PillarNetRadar as JaxRadar
from hgsfusion_tpu.models.fusion_bev import FusionAfterBEVSE as JaxFusion
from hgsfusion_tpu.models.occupancy import Conv2DCollapse as JaxCollapse
from hgsfusion_tpu.models.occupancy import RadarOccupancy2D as JaxOccupancy
from hgsfusion_tpu.models.pillar_encoder import PillarFeatureNet as JaxPFN
from hgsfusion_tpu.ops import nms as jax_nms
from hgsfusion_tpu.ops import voxelize as jax_vox
from hgsfusion_tpu.ops.rotated_iou import boxes_iou_bev as jax_iou
from hgsfusion_tpu.utils.box_coder import ResidualCoder as JaxCoder
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.models import layers
from hgsfusion_tpu_torch.models.anchor_head import AnchorHeadSingle, decode_selected_boxes
from hgsfusion_tpu_torch.models.bev_encoder import PillarNetRadar
from hgsfusion_tpu_torch.models.fusion_bev import FusionAfterBEVSE
from hgsfusion_tpu_torch.models.occupancy import Conv2DCollapse, RadarOccupancy2D
from hgsfusion_tpu_torch.models.pillar_encoder import PillarFeatureNet
from hgsfusion_tpu_torch.ops import voxelize
from hgsfusion_tpu_torch.ops.nms import class_agnostic_nms
from hgsfusion_tpu_torch.ops.rotated_iou import boxes_iou_bev
from hgsfusion_tpu_torch.utils.box_coder import ResidualCoder
from torch_parity import (assert_close, load, one_torch_thread,  # noqa: F401
                          perturb_variables, shaped_variables, t)

KEY = jax.random.PRNGKey(0)


def _init(module, *args):
    """Random variables in the shapes of ``module``'s init on ``args``, BN
    statistics not the identity (``shaped_variables``: nothing runs)."""
    return shaped_variables(module, *args, seed=7)


def _eager_init(module, *args):
    """JAX's init run eagerly, BN perturbed: for a module whose init indexes
    with concrete values (``RadarOccupancy2D``'s resize), which a trace
    cannot give."""
    return perturb_variables(module.init(KEY, *args), seed=7)


def _apply(module, variables, *args):
    out, _ = module.apply(variables, *args, mutable=["batch_stats"])
    return out


def _nhwc(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("train", [False, True])
def test_masked_batch_norm(train):
    rng = np.random.RandomState(0)
    x = _nhwc(rng, 2, 6, 7, 16)
    mask = rng.rand(2, 6, 7, 1) > 0.6
    mod = jl.MaskedBatchNorm(16)
    v = _init(mod, x, mask, True)
    ref, new = mod.apply(v, x, mask, not train, mutable=["batch_stats"])
    port = layers.MaskedBatchNorm(16)
    port.load_state_dict(weights.batch_norm(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = port(t(x), t(mask), use_running_average=not train)
    assert_close(got, ref, atol=1e-5)
    stats = new["batch_stats"]
    assert_close(port.running_mean, stats["mean"], atol=1e-6)
    assert_close(port.running_var, stats["var"], atol=1e-6)


def test_conv_bn_relu_and_se_block():
    rng = np.random.RandomState(1)
    x = _nhwc(rng, 1, 9, 11, 8)
    mod = jl.ConvBNReLU(12, kernel_size=(3, 3), dilation=2)
    v = _init(mod, x, False)
    port = load(layers.ConvBNReLU(8, 12, (3, 3), dilation=2),
                weights.conv_bn_relu(v["params"], v["batch_stats"]))
    se = jl.SEBlock(12)
    y = np.asarray(_apply(mod, v, x, False))
    vs = _init(se, y)
    port_se = load(layers.SEBlock(12), {f"att.1.{k}": w for k, w in
                                        weights.conv(vs["params"]["att_conv"]).items()})
    with torch.no_grad():
        assert_close(port(t(x)), y, atol=1e-5)
        assert_close(port_se(t(y)), _apply(se, vs, y), atol=1e-5)


@pytest.mark.parametrize("out_hw", [(15, 22), (4, 5), (8, 11)])
def test_resize_and_upsample(out_hw):
    x = _nhwc(np.random.RandomState(2), 1, 8, 11, 3)
    assert_close(layers.resize_bilinear(t(x), out_hw), jl.resize_bilinear(x, out_hw), atol=1e-6)
    assert_close(layers.upsample_bilinear_align_corners(t(x), 2),
                 jl.upsample_bilinear_align_corners(x, 2), atol=1e-6)


# ---------------------------------------------------------------- radar branch
def _radar_points(rng, n=256):
    pts = np.zeros((2, n, 17), np.float32)
    pts[..., 0] = rng.uniform(-0.3, 8.5, (2, n))  # some below / past the range
    pts[..., 1] = rng.uniform(-4.3, 4.3, (2, n))
    pts[..., 2] = rng.uniform(-1.5, 1.5, (2, n))
    pts[..., 3:15] = rng.randn(2, n, 12)
    pts[..., 15] = rng.rand(2, n) > 0.5
    pts[..., 16] = 1.0
    return pts, rng.rand(2, n) > 0.1


def test_voxelize_ops():
    rng = np.random.RandomState(3)
    pts, valid = _radar_points(rng)
    rel = pts[..., :3] - np.array([0.0, -4.0, -1.0], np.float32)
    ids_ref, in_ref = jax_vox.points_to_pillar_ids(rel, valid, 0.5, 16, 16)
    ids, in_grid = voxelize.points_to_pillar_ids(t(rel), t(valid), 0.5, 16, 16)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_ref))
    np.testing.assert_array_equal(in_grid.numpy(), np.asarray(in_ref))
    feats = rng.randn(2, pts.shape[1], 5).astype(np.float32)
    cells = voxelize.scatter_max_dense(t(feats), ids, 256)
    assert_close(cells, jax_vox.scatter_max_dense(feats, ids_ref, 256), atol=0)
    assert_close(voxelize.gather_cells(cells, ids),
                 jax_vox.gather_cells(np.asarray(cells), ids_ref), atol=0)
    np.testing.assert_array_equal(voxelize.scatter_any_dense(ids, 256).numpy(),
                                  np.asarray(jax_vox.scatter_any_dense(ids_ref, 256)))


def test_pillar_feature_net_and_radar_bev():
    rng = np.random.RandomState(4)
    pts, valid = _radar_points(rng)
    pc_range = (0.0, -4.0, -1.0, 8.0, 4.0, 1.0)
    jpfn = JaxPFN(num_input_features=29, pillar_size=0.5, pc_range=pc_range)
    v = _init(jpfn, pts, valid, False)
    bev_ref, occ_ref = _apply(jpfn, v, pts, valid, False)
    pfn = load(PillarFeatureNet(29, (32,), 0.5, pc_range),
               weights.pillar_feature_net(v["params"], v["batch_stats"]))
    with torch.no_grad():
        bev, occ = pfn(t(pts), t(valid))
    assert_close(bev, bev_ref, atol=1e-5)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))

    jradar = JaxRadar()
    occ_f = np.asarray(occ_ref).astype(np.float32)
    bev_np = np.asarray(bev_ref)
    vr = _init(jradar, bev_np, occ_f, False)
    ref = _apply(jradar, vr, bev_np, occ_f, False)
    radar = load(PillarNetRadar(), weights.pillar_net_radar(vr["params"], vr["batch_stats"]))
    with torch.no_grad():
        got = radar(t(bev_np), t(occ_f))
    assert got.shape == ref.shape == (2, 16, 16, 128)
    assert_close(got, ref, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- fusion + head
def test_collapse_occupancy_fusion():
    rng = np.random.RandomState(5)
    voxel = _nhwc(rng, 1, 12, 10, 5, 16)
    jcol = JaxCollapse(num_bev_features=24)
    vc = _init(jcol, voxel, False)
    image_bev = np.asarray(_apply(jcol, vc, voxel, False))
    col = load(Conv2DCollapse(16, 5, 24), weights.conv2d_collapse(vc["params"], vc["batch_stats"]))
    radar_bev = _nhwc(rng, 1, 8, 8, 24)
    jocc = JaxOccupancy(radar_input_channels=24, aspp_dilation=6)
    vo = _eager_init(jocc, image_bev, radar_bev, False)
    gated_ref, occ_ref = _apply(jocc, vo, image_bev, radar_bev, False)
    occ = load(RadarOccupancy2D(24, aspp_dilation=6),
               weights.radar_occupancy(vo["params"], vo["batch_stats"]))
    jfuse = JaxFusion(image_out_channels=16, radar_out_channels=16)
    gated_np = np.asarray(gated_ref)
    vf = _init(jfuse, gated_np, radar_bev, False)
    fused_ref = _apply(jfuse, vf, gated_np, radar_bev, False)
    fuse = load(FusionAfterBEVSE(48, 16, 16),
                weights.fusion_after_bev(vf["params"], vf["batch_stats"]))
    with torch.no_grad():
        assert_close(col(t(voxel)), image_bev, atol=1e-5)
        gated, occupancy = occ(t(image_bev), t(radar_bev))  # 12x10 resized to 8x8
        fused = fuse(gated, t(radar_bev))
    assert_close(occupancy, occ_ref, atol=1e-6)
    assert_close(gated, gated_ref, atol=1e-5)
    assert_close(fused, fused_ref, atol=1e-5)


def test_anchor_head_and_decode():
    rng = np.random.RandomState(6)
    x = _nhwc(rng, 1, 6, 7, 32)
    jhead = JaxHead(num_class=3, num_anchors_per_location=6)
    v = _init(jhead, x)
    ref = jhead.apply(v, x)
    head = load(AnchorHeadSingle(32, 3, 6), weights.anchor_head(v["params"]))
    with torch.no_grad():
        got = head(t(x))
    for k in ref:
        assert_close(got[k], ref[k], atol=1e-5, err_msg=k)
    anchors = np.abs(rng.randn(50, 7)).astype(np.float32) + 0.5
    rows = rng.randn(50, 7).astype(np.float32) * 0.3
    dirs = rng.randn(50, 2).astype(np.float32)
    assert_close(decode_selected_boxes(t(rows), t(dirs), t(anchors), ResidualCoder()),
                 jax_decode(rows, dirs, anchors, JaxCoder()), atol=1e-5)


# ---------------------------------------------------------------- IoU / NMS
def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(0, 12, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_rotated_iou():
    rng = np.random.RandomState(8)
    a = _boxes(rng, 40)
    b = np.concatenate([_boxes(rng, 30), a[:5],  # identical boxes
                        a[5:10] * np.array([1, 1, 1, .5, .5, 1, 1], np.float32)])  # contained
    assert_close(boxes_iou_bev(t(a), t(b)), jax_iou(a, b), atol=1e-5)


@pytest.mark.parametrize("thresh", [0.01, 0.3])
def test_class_agnostic_nms(thresh):
    rng = np.random.RandomState(9)
    boxes = _boxes(rng, 300)
    scores = rng.permutation(300).astype(np.float32) / 300.0  # tie-free
    ref_idx, ref_valid = jax_nms.class_agnostic_nms(
        scores, boxes, 0.2, thresh, pre_max_size=200, post_max_size=60)
    idx, valid = class_agnostic_nms(t(scores), t(boxes), 0.2, thresh, 200, 60)
    ref_valid = np.asarray(ref_valid)
    assert ref_valid.any()
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    np.testing.assert_array_equal(idx.numpy()[ref_valid], np.asarray(ref_idx)[ref_valid])
