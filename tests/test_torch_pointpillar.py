"""The PointPillar families against the JAX package, on the CPU, f32: the
pillar encoder's mixed and direct encodings and its multi-layer reader,
BaseBEVBackbone and RPNV2, the 9/10-dof box codes, the multi-head anchor
order and its targets, AnchorHeadMulti, both models' forward passes, the
multi-head loss and training step, and the multi-head post-processing with
its batched NMS equal to a per-class loop.

The multi-head model runs ``configs/pp_multihead_nuscenes.yaml`` cut to a
16 x 16 m range (80 x 80 pillars, a 40 x 40 head map, 32,000 anchors), as
the JAX package's own ``tests/test_multihead.py`` cuts it; PointPillarModel
runs the TINY config of ``tests/test_model.py``. One JAX compile per model,
shared by module fixtures."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgsfusion_tpu.config import load_config as jax_load_config
from hgsfusion_tpu.config import model_config_from_yaml as jax_model_config
from hgsfusion_tpu.models import anchor_head as janchor_head
from hgsfusion_tpu.models.base_bev_backbone import RPNV2 as JaxRPNV2
from hgsfusion_tpu.models.base_bev_backbone import BaseBEVBackbone as JaxBEV
from hgsfusion_tpu.models.detector import PointPillarModel as JaxPointPillar
from hgsfusion_tpu.models.detector import post_process_multihead as jax_post_process_multihead
from hgsfusion_tpu.models.pillar_encoder import PillarFeatureNet as JaxPFN
from hgsfusion_tpu.models.registry import build_network as jax_build_network
from hgsfusion_tpu.train.trainer import make_anchor_assigner as jax_make_anchor_assigner
from hgsfusion_tpu.train.trainer import make_multihead_train_step as jax_make_multihead_step
from hgsfusion_tpu.utils.box_coder import ResidualCoder as JaxCoder
from hgsfusion_tpu_torch.config import load_config, model_config_from_yaml
from hgsfusion_tpu_torch.models import anchor_head
from hgsfusion_tpu_torch.models.base_bev_backbone import RPNV2, BaseBEVBackbone
from hgsfusion_tpu_torch.models.detector import (PointPillarModel, PointPillarMultiHeadModel,
                                                 make_multihead_assigner)
from hgsfusion_tpu_torch.models.pillar_encoder import PillarFeatureNet
from hgsfusion_tpu_torch.ops.nms import class_agnostic_nms
from hgsfusion_tpu_torch.synthetic import nuscenes_batch
from hgsfusion_tpu_torch.train.trainer import make_train_step_for_cfg
from hgsfusion_tpu_torch.utils.box_coder import ResidualCoder
from hgsfusion_tpu_torch.weights import (anchor_head_multi, conv_bn_layers, from_jax_variables,
                                         pillar_feature_net)
from test_model import TINY, make_tiny_batch
from test_train import OPTIM_CFG
from torch_parity import (assert_close, compare_one_step, lift_bn_biases, load,  # noqa: F401
                          one_torch_thread, perturb_variables, port_config, shaped_variables, t,
                          to_numpy_tree)

YAML = "configs/pp_multihead_nuscenes.yaml"
CUT_RANGE = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
HEAD_TOL = 1e-4
MODULE_TOL = 1e-5


def _variables(module, *args):
    """Random variables in the shapes of the module's eval-mode init (args,
    then train=False), BN statistics not the identity (``shaped_variables``:
    nothing compiles)."""
    return shaped_variables(module, *args, False, seed=1)


def _sub(variables):
    p, s = variables["params"], variables.get("batch_stats", {})
    return to_numpy_tree(p), to_numpy_tree(s)


def _points(rng, b=2, n=256, d=5):
    pts = np.zeros((b, n, d), np.float32)
    pts[..., 0] = rng.uniform(-7.5, 7.5, (b, n))
    pts[..., 1] = rng.uniform(-7.5, 7.5, (b, n))
    pts[..., 2] = rng.uniform(-4.5, 2.5, (b, n))
    pts[..., 3:] = rng.randn(b, n, d - 3)
    valid = rng.rand(b, n) > 0.1
    return pts, valid


@pytest.mark.parametrize("encoding,filters,use_virtual,d", [
    ("mixed", (64,), False, 5), ("direct", (64,), False, 7), ("mixed", (32, 16), False, 5),
    ("split", (32, 16), True, 17)])
def test_pillar_feature_net_matches_jax(encoding, filters, use_virtual, d):
    rng = np.random.RandomState(0)
    pts, valid = _points(rng, d=d)
    if d == 17:
        pts[..., 15] = (rng.rand(*pts.shape[:2]) > 0.5)
        pts[..., 16] = 1.0
    n_in = 29 if encoding == "split" else d
    kw = dict(num_filters=filters, pillar_size=0.4, pc_range=CUT_RANGE)
    jm = JaxPFN(num_input_features=n_in, use_virtual=use_virtual, encoding_type=encoding, **kw)
    variables = _variables(jm, pts, valid)
    ref_bev, ref_occ = jm.apply(variables, pts, valid, False)
    pm = load(PillarFeatureNet(n_in, use_virtual=use_virtual, encoding_type=encoding, **kw),
              pillar_feature_net(*_sub(variables)))
    with torch.no_grad():
        bev, occ = pm(t(pts), t(valid))
    assert_close(bev, ref_bev, atol=MODULE_TOL, rtol=MODULE_TOL)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref_occ))


@pytest.mark.parametrize("which", ["BaseBEVBackbone", "RPNV2"])
def test_bev_backbone_matches_jax(which):
    rng = np.random.RandomState(1)
    if which == "BaseBEVBackbone":
        x = rng.randn(2, 16, 16, 64).astype(np.float32)
        jm, args = JaxBEV(), (x,)
        pm = BaseBEVBackbone(64)
    else:
        x = rng.randn(2, 16, 16, 128).astype(np.float32)
        xc = rng.randn(2, 8, 8, 256).astype(np.float32)
        jm, args = JaxRPNV2(layer_nums=(2, 2)), (x, xc)
        pm = RPNV2((128, 256), layer_nums=(2, 2))
    variables = _variables(jm, *args)
    ref = jm.apply(variables, *args, False)
    pm = load(pm, conv_bn_layers(*_sub(variables)))
    with torch.no_grad():
        got = pm(*(t(a) for a in args))
    assert got.shape == ref.shape
    assert_close(got, ref, atol=MODULE_TOL, rtol=MODULE_TOL)


@pytest.mark.parametrize("code_size,sincos", [(9, True), (9, False), (7, True), (7, False)])
def test_box_coder_matches_jax(code_size, sincos):
    rng = np.random.RandomState(2)
    n = 512
    extra = code_size - 7

    def boxes(scale):
        b = np.concatenate([rng.uniform(-40, 40, (n, 3)), rng.uniform(0.3, 6, (n, 3)),
                            rng.uniform(-np.pi, np.pi, (n, 1)),
                            rng.normal(0, scale, (n, extra))], axis=1)
        return b.astype(np.float32)

    def close(got_, ref_):
        # 1e-6 of each column's scale: x = xt * diagonal + xa rounds at the
        # scale of its terms (XLA fuses the product and the sum), and the
        # sum cancels where the box is near the sensor
        ref_ = np.asarray(ref_)
        scale = np.maximum(np.abs(ref_).max(axis=0), 1.0)
        assert (np.abs(got_.numpy() - ref_) <= 1e-6 * scale).all()

    gt, anchors = boxes(3.0), boxes(0.0)
    ref, got = JaxCoder(code_size, sincos), ResidualCoder(code_size, sincos)
    assert got.code_size == ref.code_size
    enc_ref = np.asarray(ref.encode(jnp.asarray(gt), jnp.asarray(anchors)))
    enc = got.encode(t(gt), t(anchors))
    close(enc, enc_ref)
    close(got.decode(t(enc_ref), t(anchors)), ref.decode(jnp.asarray(enc_ref),
                                                         jnp.asarray(anchors)))
    round_trip = got.decode(enc, t(anchors)).numpy()
    heading = np.arctan2(np.sin(gt[:, 6]), np.cos(gt[:, 6])) if sincos else gt[:, 6]
    np.testing.assert_allclose(round_trip[:, 6], heading, atol=1e-4)


@pytest.fixture(scope="module")
def mh():
    """The cut multi-head config on both sides, the JAX model's perturbed
    variables, a B=2 batch with velocity boxes, and JAX's head outputs."""
    torch.set_num_threads(1)
    jcfg = jax_load_config(YAML)
    jcfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(CUT_RANGE)
    jmc = jax_model_config(jcfg)
    pcfg = load_config(YAML)
    pcfg["DATA_CONFIG"]["POINT_CLOUD_RANGE"] = list(CUT_RANGE)
    pmc = model_config_from_yaml(pcfg)
    jmodel = jax_build_network(jcfg, jmc)
    batch = nuscenes_batch(pmc, b=2, max_points=2048, max_boxes=24, boxes_per_frame=20, seed=3)
    inputs = {k: batch[k] for k in ("points", "points_valid")}
    init = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, False))(inputs)
    variables = perturb_variables(init, seed=1)
    preds = jax.jit(lambda v, b: jmodel.apply(v, b, False))(variables, inputs)
    jassigner = jax_make_anchor_assigner(jcfg, jmc)
    return {"jcfg": jcfg, "jmc": jmc, "pcfg": pcfg, "pmc": pmc, "jmodel": jmodel,
            "batch": batch, "init": init, "variables": variables,
            "preds": jax.tree_util.tree_map(np.asarray, preds), "jassigner": jassigner,
            # JAX's targets of the batch's boxes, eager (under jit XLA fuses
            # the codes' arithmetic), computed once for the tests that read them
            "targets": jassigner(jnp.asarray(batch["gt_boxes"]))}


def test_multihead_assigner_matches_jax(mh):
    """The multi-head anchor order and the targets of velocity boxes: labels
    and weights exactly; the 10-wide codes within one f32 rounding (XLA's
    and PyTorch's log and division differ in the last bit of 0.1% of
    them)."""
    jassigner = mh["jassigner"]
    passigner = make_multihead_assigner(mh["pmc"], device="cpu")
    np.testing.assert_array_equal(passigner.flat_anchors.numpy(),
                                  np.asarray(jassigner.flat_anchors))
    assert passigner.num_per_loc == jassigner.num_per_loc
    gt = mh["batch"]["gt_boxes"]
    ref = mh["targets"]
    got = passigner(t(gt))
    labels = np.asarray(ref["box_cls_labels"])
    assert (labels > 0).sum() > 20 and (labels == -1).any()
    np.testing.assert_array_equal(got["box_cls_labels"].numpy(), labels)
    np.testing.assert_array_equal(got["reg_weights"].numpy(), np.asarray(ref["reg_weights"]))
    assert got["box_reg_targets"].shape[-1] == 10
    codes = np.asarray(ref["box_reg_targets"])
    assert_close(got["box_reg_targets"], codes, atol=0,
                 rtol=float(np.finfo(np.float32).eps) * 1.01)


def test_anchor_head_multi_matches_jax():
    rng = np.random.RandomState(4)
    pmc = model_config_from_yaml(load_config(YAML))
    x = rng.randn(2, 12, 12, 48).astype(np.float32)
    kw = dict(class_names=pmc.class_names, rpn_head_cfgs=pmc.rpn_head_cfgs,
              num_per_loc=pmc.mh_num_per_loc, code_size=10, use_dir=True)
    jm = janchor_head.AnchorHeadMulti(**kw)
    variables = _variables(jm, x)
    ref = jm.apply(variables, x, False)
    pm = load(anchor_head.AnchorHeadMulti(48, **kw), anchor_head_multi(*_sub(variables)))
    with torch.no_grad():
        got = pm(t(x))
    assert set(got) == {"cls_preds", "box_preds", "dir_cls_preds"}
    for k in got:
        for g, r in zip(got[k], ref[k]):
            assert g.shape == r.shape, k
            assert_close(g, r, atol=MODULE_TOL, rtol=MODULE_TOL, err_msg=k)


@pytest.fixture(scope="module")
def single():
    """PointPillarModel over TINY (stride-2 anchors for its head map)."""
    batch = make_tiny_batch(np.random.RandomState(0))
    jmodel = JaxPointPillar(cfg=TINY)
    variables = shaped_variables(jmodel, batch, False, seed=1)
    preds = jax.jit(lambda v, b: jmodel.apply(v, b, False))(variables, batch)
    cfg = port_config(TINY)
    cfg = dataclasses.replace(cfg, anchor_generator=tuple(
        {**c, "feature_map_stride": 2} for c in cfg.anchor_generator))
    return cfg, variables, batch, {k: np.asarray(v) for k, v in preds.items()}


@pytest.mark.parametrize("family", ["PointPillarModel", "PointPillarMultiHeadModel"])
def test_model_matches_jax(family, single, mh):
    if family == "PointPillarModel":
        cfg, variables, batch, ref = single
        model = load(PointPillarModel(cfg, device="cpu"), from_jax_variables(variables))
        assert model.anchors.shape[0] == ref["cls_preds"].size // 3
    else:
        variables, batch, ref = mh["variables"], mh["batch"], mh["preds"]
        model = load(PointPillarMultiHeadModel(mh["pmc"], device="cpu"),
                     from_jax_variables(variables))
        assert model.anchors.shape == (40 * 40 * 2 * 10, 10)
    with torch.no_grad():
        got = model(model.batch_to_device({k: np.asarray(v) for k, v in batch.items()}))
    assert set(got) == set(ref)
    for k in ref:
        pairs = zip(got[k], ref[k]) if isinstance(got[k], list) else [(got[k], ref[k])]
        for g, r in pairs:
            assert g.shape == r.shape, k
            assert_close(g, r, atol=HEAD_TOL, rtol=HEAD_TOL, err_msg=k)


def test_multi_loss_matches_jax(mh):
    """Random head outputs against the multi-head targets: every term."""
    rng = np.random.RandomState(5)
    jassigner = mh["jassigner"]
    passigner = make_multihead_assigner(mh["pmc"], device="cpu")
    preds = {k: [rng.normal(-2 if k == "cls_preds" else 0, 1.0, np.shape(p)).astype(np.float32)
                 for p in mh["preds"][k]] for k in ("cls_preds", "box_preds")}
    gt = mh["batch"]["gt_boxes"]
    lw = mh["pmc"].loss_weights
    grid_hw = 40 * 40
    ref_total, ref_tb = jax.jit(lambda p, tg: janchor_head.anchor_head_multi_loss(
        p, tg, jassigner, {k: list(v) if isinstance(v, tuple) else v for k, v in lw.items()},
        mh["jmc"].rpn_head_cfgs, grid_hw))(preds, mh["targets"])
    total, tb = anchor_head.anchor_head_multi_loss(
        {k: [t(p) for p in v] for k, v in preds.items()}, passigner(t(gt)), passigner, lw,
        mh["pmc"].rpn_head_cfgs, grid_hw)
    assert set(tb) == set(ref_tb) == {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss"}
    for k in tb:
        assert_close(tb[k], np.asarray(ref_tb[k]), atol=0, rtol=1e-5, err_msg=k)


def test_multihead_step_matches_jax(mh):
    """One B=2 step of the multi-head family (its loss, no occupancy term)
    under ``step_compare``, from weights whose BN biases are lifted
    (``torch_parity.lift_bn_biases``): with them at 0 the 20 train-mode
    conv layers' ReLUs flip under the 1e-7 probes and 60-70 tensors exceed
    the sensitivity cap for every weight and batch seed tried."""
    lw = {k: list(v) if isinstance(v, tuple) else v for k, v in mh["pmc"].loss_weights.items()}
    report = compare_one_step(
        lift_bn_biases(mh["variables"]),
        lambda tx: jax_make_multihead_step(mh["jmodel"], mh["jassigner"], tx, lw, mh["jmc"]),
        lambda: PointPillarMultiHeadModel(mh["pmc"], device="cpu"),
        lambda m, opt: make_train_step_for_cfg(m, opt, mh["pmc"])[1],
        mh["batch"], OPTIM_CFG)
    print(report)


def _tie_free_preds(mh, seed=6):
    rng = np.random.RandomState(seed)
    return {"cls_preds": [rng.normal(-3.0, 1.5, np.shape(p)).astype(np.float32)
                          for p in mh["preds"]["cls_preds"]],
            "box_preds": [rng.normal(0, 0.3, np.shape(p)).astype(np.float32)
                          for p in mh["preds"]["box_preds"]]}


# candidates per (frame, head, class) set on the CPU: the config's 1,000
# (the card's regime, chip_smoke.py) costs minutes in the plain NMS here
CPU_PRE_MAX = 200


def _cpu_model(mh):
    return PointPillarMultiHeadModel(dataclasses.replace(mh["pmc"], nms_pre_max_size=CPU_PRE_MAX),
                                     device="cpu")


def test_post_process_multihead_matches_jax(mh):
    """Per (head, class) NMS at the config's 0.2, 83 kept: the same rows as
    JAX's, block by block."""
    preds = _tie_free_preds(mh)
    jassigner = mh["jassigner"]
    post = copy.deepcopy(dict(mh["jcfg"].MODEL.POST_PROCESSING))
    post["NMS_CONFIG"] = {**post["NMS_CONFIG"], "NMS_PRE_MAXSIZE": CPU_PRE_MAX}
    ref = jax.jit(lambda p: jax_post_process_multihead(p, jassigner, mh["jmc"], post))(
        {k: [jnp.asarray(p) for p in v] for k, v in preds.items()})
    model = _cpu_model(mh)
    got = model.post_process({k: [t(p) for p in v] for k, v in preds.items()})
    assert set(got) == set(ref) == {"boxes", "scores", "labels", "valid", "vels"}
    assert got["valid"].shape == (2, 10 * 83)
    valid = np.asarray(ref["valid"])
    assert valid.sum() > 100
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["labels"].numpy()[valid], np.asarray(ref["labels"])[valid])
    for k in ("scores", "boxes", "vels"):
        assert_close(got[k].numpy()[valid], np.asarray(ref[k])[valid], atol=1e-5, err_msg=k)


def test_batched_nms_equals_a_per_class_loop(mh):
    """The one stacked NMS call keeps, in every (frame, head, class) set,
    what ``class_agnostic_nms`` of that set alone keeps."""
    preds = _tie_free_preds(mh, seed=8)
    model = _cpu_model(mh)
    got = model.post_process({k: [t(p) for p in v] for k, v in preds.items()})
    cfg = model.cfg
    row = 0
    for hi, (cp, bp) in enumerate(zip(preds["cls_preds"], preds["box_preds"])):
        s0, s1 = anchor_head.multihead_anchor_slices(cfg.class_names, cfg.rpn_head_cfgs,
                                                     cfg.mh_num_per_loc, 40 * 40)[0][hi]
        boxes = model.box_coder.decode(t(bp), model.anchors[None, s0:s1])
        for ci in range(cp.shape[-1]):
            scores = torch.sigmoid(t(cp[..., ci]))
            idx, valid = class_agnostic_nms(scores, boxes[..., :7], cfg.score_thresh,
                                            cfg.nms_thresh, cfg.nms_pre_max_size,
                                            cfg.nms_post_max_size)
            block = slice(row, row + cfg.nms_post_max_size)
            np.testing.assert_array_equal(got["valid"][:, block].numpy(), valid.numpy())
            want = torch.take_along_dim(boxes[..., :7], idx[..., None], dim=1)
            np.testing.assert_array_equal(got["boxes"][:, block][valid].numpy(),
                                          want[valid].numpy())
            row += cfg.nms_post_max_size
    assert row == got["valid"].shape[1]


def test_nuscenes_batch_shapes():
    pmc = model_config_from_yaml(load_config(YAML))
    b = nuscenes_batch(pmc, b=1, max_points=4096, seed=0)
    assert b["points"].shape == (1, 4096, 5) and b["gt_boxes"].shape == (1, 128, 10)
    assert b["points_valid"].sum() == int(0.85 * 4096)
    assert set(np.unique(b["gt_boxes"][0, :40, 9])) == set(range(1, 11))
    pr = pmc.pc_range
    pts = b["points"][0][b["points_valid"][0]]
    assert (pts[:, 0] > pr[0]).all() and (pts[:, 0] < pr[3]).all()
    assert copy.deepcopy(b)["gt_boxes"][0, 40:].sum() == 0
