"""The TransFusion head and its training pieces (``models/transfusion_head.py``,
``models/center_head.py``, ``ops/rotated_iou.py::boxes_iou3d``) against the
JAX package's, on the CPU, f32: the head in eval mode within 1e-4 (its
proposals matched by (class, cell): ranks whose scores lie within 1e-5 of a
neighbour's may swap, every other rank must agree), box encode / decode
round trips, ``hungarian_match`` equal to JAX's (optax) on costs with a
unique optimum, with padded and with no valid gt, the loss terms and their
gradients within 1e-5 relative, ``transfusion_get_boxes``, the heatmap
targets and the 3-D IoU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgsfusion_tpu.models import center_head as jch
from hgsfusion_tpu.models import transfusion_head as jtf
from hgsfusion_tpu.ops.rotated_iou import boxes_iou3d as jax_iou3d
from hgsfusion_tpu.ops.topk import exact_top_k
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.models import center_head, transfusion_head as tf
from hgsfusion_tpu_torch.ops.rotated_iou import boxes_iou3d
from torch_parity import assert_close, one_torch_thread, shaped_variables, t  # noqa: F401

PC_RANGE = (0.0, -8.0, -3.0, 16.0, 8.0, 2.0)
VOXEL = (0.5, 0.5, 0.5)
HEAD = dict(num_class=3, hidden=32, num_proposals=20, num_heads=4, ffn=64)
HEAD_TOL = 1e-4
TIE = 1e-5


def _boxes(rng, shape):
    b = np.zeros(shape + (7,), np.float32)
    b[..., 0] = rng.uniform(1, 15, shape)
    b[..., 1] = rng.uniform(-7, 7, shape)
    b[..., 2] = rng.uniform(-2, 1, shape)
    b[..., 3:6] = rng.uniform(0.5, 4, shape + (3,))
    b[..., 6] = rng.uniform(-np.pi, np.pi, shape)
    return b


@pytest.fixture(scope="module")
def head():
    feats = np.random.RandomState(0).randn(2, 8, 8, 24).astype(np.float32)
    module = jtf.TransFusionHead(**HEAD)
    variables = shaped_variables(module, feats, False, seed=1)
    ref = jax.jit(lambda v, x: module.apply(v, x, False))(variables, feats)
    port = tf.TransFusionHead(24, **HEAD)
    port.load_state_dict(weights.transfusion_head(variables["params"], variables["batch_stats"]),
                         strict=True)
    with torch.no_grad():
        got = port.eval()(t(feats))
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in got.items()}


def _scores(out):
    return (out["query_heatmap_score"] * np.eye(3)[out["query_labels"]]).sum(-1)


def test_head_matches_jax(head):
    ref, got = head
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["dense_heatmap"], ref["dense_heatmap"], atol=HEAD_TOL)
    for b in range(2):
        s = _scores(ref)[b]
        assert (s > 0).sum() >= 6  # enough peaks to rank
        gap = np.abs(np.diff(s))
        tied = np.zeros(s.shape, bool)
        tied[:-1] |= (gap < TIE) & (s[:-1] > 0)
        tied[1:] |= (gap < TIE) & (s[1:] > 0)
        for k in ("query_labels", "query_pos"):
            np.testing.assert_array_equal(got[k][b][~tied], ref[k][b][~tied], err_msg=k)
        # every proposal, matched by (class, cell)
        key = {(int(lab), *map(float, pos)): i for i, (lab, pos) in
               enumerate(zip(ref["query_labels"][b], ref["query_pos"][b]))}
        order = [key[(int(lab), *map(float, pos))]
                 for lab, pos in zip(got["query_labels"][b], got["query_pos"][b])]
        for k in ("heatmap", "center", "height", "dim", "rot", "query_heatmap_score"):
            np.testing.assert_allclose(got[k][b], ref[k][b][order], atol=HEAD_TOL, rtol=HEAD_TOL,
                                       err_msg=k)


def test_top_scores_breaks_ties_by_index():
    flat = torch.tensor([[0.5, 0.0, 0.7, 0.5, 0.0, 0.7, 0.1]])
    values, idx = tf.top_scores(flat, 6)
    assert idx.tolist() == [[2, 5, 0, 3, 6, 1]]
    ref_v, ref_i = jax.vmap(lambda s: exact_top_k(s, 6))(jnp.asarray(flat.numpy()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_v))


def test_encode_decode_round_trip():
    rng = np.random.RandomState(2)
    boxes = _boxes(rng, (2, 9))
    enc = tf.encode_transfusion_boxes(t(boxes), PC_RANGE, VOXEL, 2)
    assert_close(enc, np.asarray(jtf.encode_transfusion_boxes(jnp.asarray(boxes), PC_RANGE,
                                                               VOXEL, 2)), atol=1e-6)
    preds = {"center": enc[..., 0:2], "height": enc[..., 2:3], "dim": enc[..., 3:6],
             "rot": enc[..., 6:8]}
    dec = tf.decode_transfusion_boxes(preds, PC_RANGE, VOXEL, 2)
    assert_close(dec, boxes, atol=1e-5)
    ref = jtf.decode_transfusion_boxes({k: jnp.asarray(v.numpy()) for k, v in preds.items()},
                                       PC_RANGE, VOXEL, 2)
    assert_close(dec, np.asarray(ref), atol=1e-6)


def _match_inputs(seed, p=12, m=5, valid_rows=(3, 0)):
    rng = np.random.RandomState(seed)
    pred = _boxes(rng, (2, p))
    logits = rng.randn(2, p, 3).astype(np.float32)
    gt = _boxes(rng, (2, m))
    gt[:, :, :2] = pred[:, :m, :2] + rng.uniform(-1, 1, (2, m, 2))  # overlaps
    labels = rng.randint(0, 3, (2, m))
    valid = np.zeros((2, m), bool)
    for b, n in enumerate(valid_rows):
        valid[b, :n] = True
    return pred, logits, gt, labels, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_hungarian_matches_jax(seed):
    """Frame 0 has 3 valid of 5 gt columns, frame 1 none: no proposal
    matches there."""
    args = _match_inputs(seed)
    ref = jax.jit(jax.vmap(lambda *a: jtf.hungarian_match(*a, PC_RANGE)))(
        *map(jnp.asarray, args))
    got = tf.hungarian_match(*map(t, args), PC_RANGE)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert got[1][0].sum() == 3 and not got[1][1].any()
    assert_close(got[2], np.asarray(ref[2]), atol=1e-6)
    cost, _ = tf.assignment_costs(*map(t, args), PC_RANGE)
    assert bool((cost[1] == tf.PAD_COST).all())


def _loss_inputs(seed=3, p=16):
    rng = np.random.RandomState(seed)
    preds = {"dense_heatmap": rng.randn(2, 16, 16, 3).astype(np.float32),
             "heatmap": rng.randn(2, p, 3).astype(np.float32),
             "center": rng.uniform(0, 16, (2, p, 2)).astype(np.float32),
             "height": rng.randn(2, p, 1).astype(np.float32),
             "dim": rng.randn(2, p, 3).astype(np.float32) * 0.1,
             "rot": rng.randn(2, p, 2).astype(np.float32)}
    gt = np.zeros((2, 4, 8), np.float32)
    gt[0, 0] = [4, -2, -0.5, 3.9, 1.6, 1.56, 0.3, 1]
    gt[0, 1] = [10, 3, -0.2, 0.8, 0.6, 1.73, -1.0, 2]
    gt[1, 0] = [7, 5, -0.3, 1.8, 0.6, 1.73, 2.0, 3]
    return preds, gt


def test_loss_and_gradient_match_jax():
    preds, gt = _loss_inputs()
    args = (3, PC_RANGE, VOXEL, 2, (16, 16))

    def jax_loss(pr):
        return jtf.transfusion_loss(pr, jnp.asarray(gt), *args)

    (ref_total, ref_tb), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in preds.items()})
    tp = {k: t(v).requires_grad_() for k, v in preds.items()}
    total, tb = tf.transfusion_loss(tp, t(gt), *args)
    total.backward()
    assert float(tb["matched_ious"]) >= 0 and float(ref_total) > 0
    assert_close(total, float(ref_total), atol=0, rtol=1e-5)
    for k, v in ref_tb.items():
        assert_close(tb[k], float(v), atol=1e-7, rtol=1e-5, err_msg=k)
    for k, g in ref_grads.items():
        g = np.asarray(g)
        assert_close(tp[k].grad, g, atol=1e-5 * float(np.abs(g).max()) + 1e-12, err_msg=k)


def test_get_boxes_matches_jax():
    preds, _ = _loss_inputs(seed=4)
    rng = np.random.RandomState(5)
    preds["query_labels"] = rng.randint(0, 3, (2, 16))
    preds["query_heatmap_score"] = rng.rand(2, 16, 3).astype(np.float32)
    limit = (-5.0, -30.0, -5.0, 13.0, 30.0, 5.0)
    ref = jtf.transfusion_get_boxes({k: jnp.asarray(v) for k, v in preds.items()}, PC_RANGE,
                                    VOXEL, 2, 0.1, limit)
    got = tf.transfusion_get_boxes({k: t(v) for k, v in preds.items()}, PC_RANGE, VOXEL, 2,
                                   0.1, limit)
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert 0 < int(got["valid"].sum()) < 32
    for k in ("boxes", "scores"):
        assert_close(got[k], np.asarray(ref[k]), atol=1e-6, err_msg=k)


def test_center_targets_match_jax():
    _, gt = _loss_inputs()
    rng = np.random.RandomState(6)
    dx, dy = rng.uniform(0.5, 12, 50).astype(np.float32), rng.uniform(0.5, 12, 50).astype(
        np.float32)
    assert_close(center_head.gaussian_radius(t(dx), t(dy), 0.1),
                 np.asarray(jch.gaussian_radius(jnp.asarray(dx), jnp.asarray(dy), 0.1)),
                 atol=1e-5)
    ref = jch.center_targets(jnp.asarray(gt), 3, (16, 16), 2, PC_RANGE, VOXEL)
    got = center_head.center_targets(t(gt), 3, (16, 16), 2, PC_RANGE, VOXEL)
    for k in ("inds", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in ("heatmap", "boxes"):
        assert_close(got[k], np.asarray(ref[k]), atol=1e-6, err_msg=k)
    assert int((got["heatmap"] == 1.0).sum()) == 3


def test_boxes_iou3d_matches_jax():
    rng = np.random.RandomState(7)
    a, b = _boxes(rng, (9,)), _boxes(rng, (6,))
    b[:4, :3] = a[:4, :3] + rng.uniform(-0.5, 0.5, (4, 3))
    got = boxes_iou3d(t(a), t(b))
    assert_close(got, np.asarray(jax_iou3d(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)
    assert float(got.max()) > 0.05
