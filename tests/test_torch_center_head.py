"""The CenterHead, its losses, its decode and its NMS-backed evaluation
(``models/center_head.py``, ``models/detector.py::center_post_process``)
against the JAX package's, on the CPU, f32: the head in eval mode within
1e-5 of the largest output; ``centernet_focal_loss`` (with and without a
positive cell), ``center_reg_loss`` (non-finite targets masked) and
``center_head_loss`` within 1e-5 relative, their gradients within 1e-5 of
the largest; ``decode_center_boxes`` with K past C H W (padded) and with
``vel``, equal to JAX's wherever no score lies within 1e-5 of a
neighbour's (ROADMAP's ties rule: candidates matched by (class, cell)); the
evaluation (decode + NMS) equal to JAX's ``make_center_eval_step``, with
the near-duplicate-peak case of ``tests/test_centerpoint.py``. The TINY
size: 0.5 m voxels over (0, -8, -3, 16, 8, 2), the head at stride 2 (a
16 x 16 map)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgsfusion_tpu.models import center_head as jch
from hgsfusion_tpu.models.detector import HGSFusionConfig as JaxConfig
from hgsfusion_tpu.train.trainer import make_center_eval_step as jax_center_eval_step
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.models import center_head as ch
from hgsfusion_tpu_torch.models.detector import center_post_process, init_weights
from torch_parity import assert_close, one_torch_thread, port_config, shaped_variables, t  # noqa: F401

PC_RANGE = (0.0, -8.0, -3.0, 16.0, 8.0, 2.0)
VOXEL = (0.5, 0.5, 0.5)
TIE = 1e-5
TOL = 1e-5
ORDER = ("center", "center_z", "dim", "rot")
ORDER_VEL = ORDER + ("vel",)


def _preds(seed, b=2, h=16, w=16, c=3, vel=False, spread=2.0):
    """Random head outputs: heatmap logits, offsets in a cell, z, log dims
    near log 1.5 m, (cos, sin), velocities."""
    rng = np.random.RandomState(seed)
    out = {"hm": rng.randn(b, h, w, c).astype(np.float32) * spread,
           "center": rng.uniform(0, 1, (b, h, w, 2)).astype(np.float32),
           "center_z": rng.uniform(-2, 1, (b, h, w, 1)).astype(np.float32),
           "dim": (np.log(1.5) + 0.3 * rng.randn(b, h, w, 3)).astype(np.float32),
           "rot": rng.randn(b, h, w, 2).astype(np.float32)}
    if vel:
        out["vel"] = rng.randn(b, h, w, 2).astype(np.float32)
    return out


def _gt(vel=False):
    gt = np.zeros((2, 5, 10 if vel else 8), np.float32)
    rows = [(0, 0, [4, -2, -0.5, 3.9, 1.6, 1.56, 0.3]), (0, 1, [10, 3, -0.2, 0.8, 0.6, 1.73, -1.0]),
            (0, 2, [12.3, -6.1, 0.1, 1.8, 0.6, 1.73, 2.4]), (1, 0, [7, 5, -0.3, 1.8, 0.6, 1.73, 2.0])]
    for (b, m, box), cls in zip(rows, (1, 2, 3, 3)):
        gt[b, m, :7] = box
        if vel:
            gt[b, m, 7:9] = [0.5 * m - 1.0, 0.25 * b + 0.5]
        gt[b, m, -1] = cls
    return gt


@pytest.fixture(scope="module")
def head():
    feats = np.random.RandomState(0).randn(2, 12, 10, 24).astype(np.float32)
    module = jch.CenterHead(num_class=3, shared_channels=16, head_order=ORDER_VEL,
                            head_channels=(2, 1, 3, 2, 2))
    variables = shaped_variables(module, feats, False, seed=1)
    ref = jax.jit(lambda v, x: module.apply(v, x, False))(variables, feats)
    port = ch.CenterHead(24, 3, 16, ORDER_VEL, (2, 1, 3, 2, 2))
    port.load_state_dict(weights.center_head(variables["params"], variables["batch_stats"]),
                         strict=True)
    with torch.no_grad():
        got = port.eval()(t(feats))
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in got.items()}


def test_head_matches_jax(head):
    ref, got = head
    assert set(got) == set(ref) == set(ORDER_VEL) | {"hm"}
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == np.float32, k
        assert_close(got[k], ref[k], atol=TOL * float(np.abs(ref[k]).max()), err_msg=k)


def test_head_init_and_flax_batch_norms():
    """The hm branch's last bias at -2.19, every other output bias 0; the
    BatchNorms flax's eps 1e-5 and momentum 0.9 (torch 0.1)."""
    port = ch.CenterHead(8, 3, head_order=ORDER_VEL, head_channels=(2, 1, 3, 2, 2))
    init_weights(port, torch.Generator().manual_seed(0))
    port.init_biases()
    assert torch.equal(port.head.hm_out.bias, torch.full((3,), -2.19))
    for name in ORDER_VEL:
        assert not getattr(port.head, f"{name}_out").bias.any()
    bns = [m for m in port.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == 1 + 5 + 1 and all(m.eps == 1e-5 and m.momentum == 0.1 for m in bns)
    assert port.shared_conv.bias is None and port.head.hm_conv0.bias is None


@pytest.mark.parametrize("positives", [True, False])
def test_focal_loss_and_gradient_match_jax(positives):
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 16, 16, 3).astype(np.float32) * 3
    gt = jax.jit(lambda g: jch.center_targets(g, 3, (16, 16), 2, PC_RANGE, VOXEL)["heatmap"])(
        _gt())
    gt = np.asarray(gt) if positives else np.asarray(gt) * 0.9  # no cell at 1: num_pos 0
    assert ((gt == 1.0).sum() > 0) == positives
    ref, ref_g = jax.jit(jax.value_and_grad(jch.centernet_focal_loss))(logits, gt)
    x = t(logits).requires_grad_()
    got = ch.centernet_focal_loss(x, t(gt))
    got.backward()
    assert_close(got, float(ref), atol=0, rtol=TOL)
    g = np.asarray(ref_g)
    assert_close(x.grad, g, atol=TOL * float(np.abs(g).max()))


def test_reg_and_head_loss_match_jax():
    """Non-finite targets are masked out; the per-channel sum divides by the
    object count; the total and its gradients."""
    preds = _preds(4, vel=True)
    targets = jax.jit(lambda g: jch.center_targets(g, 3, (16, 16), 2, PC_RANGE, VOXEL,
                                                   code_size=10))(_gt(vel=True))
    targets = {k: np.array(v) for k, v in targets.items()}
    targets["boxes"][0, 1, 3] = np.inf
    targets["boxes"][1, 0, 8] = np.nan
    reg = np.concatenate([preds[k] for k in ORDER_VEL], -1)
    ref = jax.jit(jch.center_reg_loss)(reg, *(targets[k] for k in ("inds", "mask", "boxes")))
    got = ch.center_reg_loss(t(reg), *(t(targets[k]) for k in ("inds", "mask", "boxes")))
    assert np.isfinite(got.numpy()).all()
    assert_close(got, np.asarray(ref), atol=1e-7, rtol=TOL)
    weights_ = [1.0] * 8 + [0.2, 0.2]

    def jax_loss(p):
        return jch.center_head_loss(p, {k: jnp.asarray(v) for k, v in targets.items()},
                                    ORDER_VEL, weights_, 1.0, 0.25)

    (ref_total, ref_tb), ref_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in preds.items()})
    tp = {k: t(v).requires_grad_() for k, v in preds.items()}
    total, tb = ch.center_head_loss(tp, {k: t(v) for k, v in targets.items()}, ORDER_VEL,
                                    weights_, 1.0, 0.25)
    total.backward()
    assert_close(total, float(ref_total), atol=0, rtol=TOL)
    for k, v in ref_tb.items():
        assert_close(tb[k], float(v), atol=0, rtol=TOL, err_msg=k)
    for k, g in ref_g.items():
        g = np.asarray(g)
        assert_close(tp[k].grad, g, atol=TOL * float(np.abs(g).max()), err_msg=k)


def _tied(scores):
    """Ranks whose score lies within TIE of a neighbour's (and above 0)."""
    close = (np.abs(np.diff(scores)) < TIE) & (scores[1:] > 0)
    tied = np.zeros(scores.shape, bool)
    tied[1:] |= close
    tied[:-1] |= close
    return tied


def _assert_same_candidates(got, ref, keys, atol=1e-5):
    """Per frame: labels and boxes equal at every tie-free rank; every
    candidate matched by (class, cell) within ``atol``."""
    for b in range(ref["scores"].shape[0]):
        tied = _tied(ref["scores"][b])
        np.testing.assert_array_equal(got["labels"][b][~tied], ref["labels"][b][~tied])
        np.testing.assert_array_equal(got["valid"][b][~tied], ref["valid"][b][~tied])
        key = {(int(lab), *np.round(box[:2], 4)): i
               for i, (lab, box) in enumerate(zip(ref["labels"][b], ref["boxes"][b]))}
        order = [key[(int(lab), *np.round(box[:2], 4))]
                 for lab, box in zip(got["labels"][b], got["boxes"][b])]
        for k in keys:
            np.testing.assert_allclose(got[k][b], ref[k][b][order], atol=atol, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("case", ["plain", "vel", "k_past_cells"])
def test_decode_matches_jax(case):
    preds = _preds(5, h=8 if case == "k_past_cells" else 16, w=8 if case == "k_past_cells" else 16,
                   vel=case == "vel")
    k = 250 if case == "k_past_cells" else 60  # 3 x 8 x 8 = 192 cells
    limit = (-1.0, -9.0, -5.0, 14.0, 9.0, 5.0)
    ref = jax.jit(lambda p: jch.decode_center_boxes(p, k, 2, PC_RANGE, VOXEL, limit,
                                                    score_thresh=0.3))(preds)
    got = ch.decode_center_boxes({n: t(v) for n, v in preds.items()}, k, 2, PC_RANGE, VOXEL,
                                 limit, score_thresh=0.3)
    ref = {n: np.asarray(v) for n, v in ref.items()}
    got = {n: v.numpy() for n, v in got.items()}
    assert set(got) == set(ref) and got["boxes"].shape == (2, k, 7)
    assert ("vels" in got) == (case == "vel")
    if case == "k_past_cells":
        assert not got["valid"][:, 192:].any() and not got["scores"][:, 192:].any()
    assert 0 < got["valid"].sum() < got["valid"].size
    _assert_same_candidates(got, ref, ("boxes", "scores") + (("vels",) if case == "vel" else ()))


def _eval_cfg(nms_thresh, pre, post, k):
    jcfg = JaxConfig(pc_range=PC_RANGE, voxel_size=VOXEL, center_max_k=k,
                     center_post_limit=(-5.0, -30.0, -5.0, 55.0, 30.0, 5.0))
    post_cfg = {"SCORE_THRESH": 0.1, "NMS_CONFIG": {"NMS_TYPE": "nms_gpu",
                                                    "NMS_THRESH": nms_thresh,
                                                    "NMS_PRE_MAXSIZE": pre,
                                                    "NMS_POST_MAXSIZE": post}}
    pcfg = port_config(jcfg, score_thresh=0.1, nms_thresh=nms_thresh, nms_pre_max_size=pre,
                       nms_post_max_size=post)
    return jcfg, post_cfg, pcfg


class _Stub:
    def __init__(self, preds):
        self.preds = preds

    def apply(self, variables, inputs, train):
        return self.preds


def _jax_eval(jcfg, post_cfg, preds):
    ev = jax_center_eval_step(_Stub({k: jnp.asarray(v) for k, v in preds.items()}), jcfg,
                              post_cfg)
    out = jax.jit(lambda b: ev({}, {}, b))({"points": np.zeros((1, 4, 5), np.float32),
                                            "points_valid": np.ones((1, 4), bool)})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("vel", [False, True])
def test_eval_with_nms_matches_jax(vel):
    """Decode (60 candidates) then one class-agnostic NMS at IoU 0.2 over
    boxes of about 1.5 m whose centers lie a cell (1 m) apart: the keep
    sets, slots, boxes and scores equal JAX's."""
    preds = _preds(6, vel=vel, spread=1.0)
    jcfg, post_cfg, pcfg = _eval_cfg(0.2, 4096, 30, 60)
    ref = _jax_eval(jcfg, post_cfg, preds)
    dec = ch.decode_center_boxes({k: t(v) for k, v in preds.items()}, 60, 2, PC_RANGE, VOXEL,
                                 jcfg.center_post_limit, 0.1)
    assert _tied(dec["scores"].numpy().ravel()).sum() == 0  # a tie-free input
    got = {k: v.numpy() for k, v in center_post_process({k: t(v) for k, v in preds.items()},
                                                        pcfg).items()}
    assert set(got) == set(ref) and got["boxes"].shape == (2, 30, 7)
    for k in ("valid", "labels"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    kept = got["valid"].sum(1)
    assert (kept > 3).all() and (kept < dec["valid"].numpy().sum(1)).all()  # NMS suppressed
    for k in ("boxes", "scores") + (("vels",) if vel else ()):
        assert_close(got[k], ref[k], atol=1e-5, err_msg=k)


def test_near_duplicate_peaks_are_suppressed():
    """tests/test_centerpoint.py's case: a peak, its shoulder a cell away
    (the same 2 x 2 m box) and a second object; the NMS keeps two, the raw
    decode (no NMS_CONFIG) three, as in JAX; circle_nms raises."""
    h = w = 16
    logit = np.full((1, h, w, 3), -10.0, np.float32)
    logit[0, 5, 5, 0] = 6.0
    logit[0, 5, 6, 0] = 5.0
    logit[0, 10, 12, 1] = 6.0
    preds = {"hm": logit, "center": np.zeros((1, h, w, 2), np.float32),
             "center_z": np.zeros((1, h, w, 1), np.float32),
             "dim": np.log(np.full((1, h, w, 3), 2.0, np.float32)),
             "rot": np.concatenate([np.ones((1, h, w, 1)), np.zeros((1, h, w, 1))],
                                   -1).astype(np.float32)}
    jcfg, post_cfg, pcfg = _eval_cfg(0.2, 16, 8, 16)
    jcfg = dataclasses.replace(jcfg, center_post_limit=(-75.0, -75.0, -10.0, 75.0, 75.0, 10.0))
    pcfg = dataclasses.replace(pcfg, center_post_limit=jcfg.center_post_limit)
    ref = _jax_eval(jcfg, post_cfg, preds)
    got = {k: v.numpy() for k, v in center_post_process({k: t(v) for k, v in preds.items()},
                                                        pcfg).items()}
    assert got["boxes"].shape == (1, 8, 7) and int(got["valid"].sum()) == 2
    for k in ("valid", "labels"):
        np.testing.assert_array_equal(got[k], ref[k])
    for k in ("boxes", "scores"):
        assert_close(got[k], ref[k], atol=1e-6)
    raw = center_post_process({k: t(v) for k, v in preds.items()},
                              dataclasses.replace(pcfg, nms_type=None))
    ref_raw = _jax_eval(jcfg, {"SCORE_THRESH": 0.1}, preds)
    assert int(raw["valid"].sum()) == int(ref_raw["valid"].sum()) == 3
    with pytest.raises(NotImplementedError, match="circle_nms"):
        center_post_process({k: t(v) for k, v in preds.items()},
                            dataclasses.replace(pcfg, nms_type="circle_nms"))
