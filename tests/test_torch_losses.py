"""Target assignment, losses, occupancy target, schedules and optimizer of the
port against the JAX package, on the CPU.

The gt boxes keep their class anchor's size and sit off voxel edges, so no
two anchors reach a gt's maximum IoU at once and the force-match argmax
cannot break a tie differently on the two sides.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hgsfusion_tpu.config import ConfigDict
from hgsfusion_tpu.models import anchor_head as jhead
from hgsfusion_tpu.models.anchors import TargetAssigner as JaxAssigner
from hgsfusion_tpu.models.occupancy import occupancy_loss as jax_occupancy_loss
from hgsfusion_tpu.models.occupancy import rasterize_gt_boxes_bev as jax_rasterize
from hgsfusion_tpu.train import optim as joptim
from hgsfusion_tpu.utils import box_utils as jbox
from hgsfusion_tpu.utils.box_coder import ResidualCoder as JaxCoder
from hgsfusion_tpu_torch.models import anchor_head
from hgsfusion_tpu_torch.models.anchors import TargetAssigner
from hgsfusion_tpu_torch.models.registry import network_class
from hgsfusion_tpu_torch.models.occupancy import occupancy_loss, rasterize_gt_boxes_bev
from hgsfusion_tpu_torch.train import optim
from hgsfusion_tpu_torch.utils import box_utils
from hgsfusion_tpu_torch.utils.box_coder import ResidualCoder
from test_model import ANCHOR_CFG, TINY
from test_train import LOSS_WEIGHTS, OPTIM_CFG
from torch_parity import assert_close, one_torch_thread, t  # noqa: F401

CLASS_SIZE = {1: (3.9, 1.6, 1.56, -1.78), 2: (0.8, 0.6, 1.73, -0.6), 3: (1.76, 0.6, 1.73, -0.6)}


def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(0, 12, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _gt(rng, classes, b=2, m=8):
    """(B, M, 8) padded gt boxes of ``classes`` per image, near their anchor
    size, inside the TINY range, centers off voxel edges; image 1 also gets
    a box outside the range (it overlaps no anchor, so nothing is forced)."""
    gt = np.zeros((b, m, 8), np.float32)
    for i in range(b):
        for j, c in enumerate(classes[i]):
            dx, dy, dz, bottom = CLASS_SIZE[c]
            s = rng.uniform(0.92, 1.08, 3)
            gt[i, j] = [rng.uniform(1.0, 15.0) + 0.13, rng.uniform(-7.0, 7.0) + 0.11,
                        bottom + dz * s[2] / 2, dx * s[0], dy * s[1], dz * s[2],
                        rng.uniform(-np.pi, np.pi), c]
    return gt


def test_box_coder_encode_and_bev_iou():
    rng = np.random.RandomState(0)
    boxes, anchors = _boxes(rng, 60), _boxes(rng, 60)
    assert_close(ResidualCoder().encode(t(boxes), t(anchors)),
                 JaxCoder().encode(boxes, anchors), atol=1e-5, rtol=1e-5)
    a, b = _boxes(rng, 40), np.concatenate([_boxes(rng, 20), _boxes(rng, 10)[:, :7]])
    aligned = box_utils.boxes3d_lidar_to_aligned_bev_boxes(t(a))
    assert_close(aligned, jbox.boxes3d_lidar_to_aligned_bev_boxes(a), atol=1e-6)
    assert_close(box_utils.boxes_iou_normal(aligned, aligned[:7]),
                 jbox.boxes_iou_normal(np.asarray(aligned), np.asarray(aligned[:7])), atol=1e-6)
    assert_close(box_utils.boxes3d_nearest_bev_iou(t(a), t(b)),
                 jbox.boxes3d_nearest_bev_iou(a, b), atol=1e-6)


@pytest.fixture(scope="module")
def assigned():
    """JAX and port targets of the TINY anchors for images with Car + Ped,
    Cyclist + Car + a box outside the range, and one with no box at all."""
    rng = np.random.RandomState(1)
    gt = np.concatenate([_gt(rng, [(1, 2), (3, 1)]), np.zeros((1, 8, 8), np.float32)])
    gt[1, 2] = [40.0, 30.0, -0.5, 3.9, 1.6, 1.56, 0.2, 1]
    ref = JaxAssigner(ANCHOR_CFG, TINY.grid_size, TINY.pc_range,
                      class_names=TINY.class_names)(jnp.asarray(gt))
    got = TargetAssigner(ANCHOR_CFG, TINY.grid_size, TINY.pc_range, TINY.class_names,
                         device="cpu")(t(gt))
    return gt, {k: np.asarray(v) for k, v in ref.items()}, got


def test_target_assigner_matches_jax(assigned):
    _, ref, got = assigned
    labels = ref["box_cls_labels"]
    # both images with boxes have positives of their classes; the empty one
    # is all background; some anchors are ignored (between the thresholds)
    assert set(np.unique(labels[0])) >= {0, 1, 2} and 3 in labels[1]
    assert (labels[2] == 0).all() and (labels == -1).any()
    np.testing.assert_array_equal(got["box_cls_labels"].numpy(), labels)
    np.testing.assert_array_equal(got["reg_weights"].numpy(), ref["reg_weights"])
    assert_close(got["box_reg_targets"], ref["box_reg_targets"], atol=1e-5)
    # the multi-head order is ported (its targets: test_torch_pointpillar.py):
    # the same labels, one block per class; the zoo's second-stage families
    # (queue 1 item 9) are not
    multi = TargetAssigner(ANCHOR_CFG, TINY.grid_size, TINY.pc_range, TINY.class_names,
                           use_multihead=True, device="cpu")
    mh = multi(torch.from_numpy(np.asarray(assigned[0])))["box_cls_labels"].numpy()
    np.testing.assert_array_equal(np.sort(mh, axis=1), np.sort(labels, axis=1))
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        network_class("PointRCNN")


def test_anchor_head_loss_matches_jax(assigned):
    """Random head outputs against the assigned targets: every loss term,
    with the direction loss and the code weights."""
    _, ref_targets, got_targets = assigned
    rng = np.random.RandomState(2)
    nx, ny, _ = TINY.grid_size
    a = TINY.num_anchors_per_location
    preds = {"cls_preds": rng.normal(-2, 1.5, (3, ny, nx, a * 3)).astype(np.float32),
             "box_preds": rng.normal(0, 0.3, (3, ny, nx, a * 7)).astype(np.float32),
             "dir_cls_preds": rng.normal(0, 1, (3, ny, nx, a * 2)).astype(np.float32)}
    anchors = JaxAssigner(ANCHOR_CFG, TINY.grid_size, TINY.pc_range,
                          class_names=TINY.class_names).flat_anchors
    ref_loss, ref_tb = jhead.anchor_head_loss(
        {k: jnp.asarray(v) for k, v in preds.items()},
        {k: jnp.asarray(v) for k, v in ref_targets.items()}, anchors, 3, LOSS_WEIGHTS)
    loss, tb = anchor_head.anchor_head_loss({k: t(v) for k, v in preds.items()}, got_targets,
                                            t(np.asarray(anchors)), 3, LOSS_WEIGHTS)
    assert set(tb) == set(ref_tb) == {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss"}
    for k in ref_tb:
        assert_close(tb[k], ref_tb[k], atol=0, rtol=1e-5, err_msg=k)
    assert_close(loss, ref_loss, atol=0, rtol=1e-5)


def test_loss_pieces_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.normal(0, 2, (2, 50, 3)).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (2, 50))][..., 1:]
    w = rng.rand(2, 50).astype(np.float32)
    assert_close(anchor_head.sigmoid_focal_loss(t(logits), t(onehot), t(w)),
                 jhead.sigmoid_focal_loss(logits, onehot, w), atol=1e-6, rtol=1e-5)
    pred = rng.normal(0, 1, (2, 50, 7)).astype(np.float32)
    target = rng.normal(0, 1, (2, 50, 7)).astype(np.float32)
    target[0, :5, 2] = np.nan  # a NaN target takes the prediction: zero loss
    got = anchor_head.weighted_smooth_l1(t(pred), t(target), t(w), code_weights=[2.0] * 7)
    assert_close(got, jhead.weighted_smooth_l1(pred, target, w, code_weights=[2.0] * 7),
                 atol=1e-6, rtol=1e-5)
    assert (got[0, :5, 2] == 0).all()
    dir_logits, dir_onehot = logits[..., :2], onehot[..., :2]
    assert_close(anchor_head.weighted_cross_entropy(t(dir_logits), t(dir_onehot), t(w)),
                 jhead.weighted_cross_entropy(dir_logits, dir_onehot, w), atol=1e-6, rtol=1e-5)
    b1, b2 = anchor_head.add_sin_difference(t(pred), t(target))
    r1, r2 = jhead.add_sin_difference(pred, target)
    assert_close(b1, r1, atol=1e-6)
    assert_close(b2, r2, atol=1e-6)
    anchors = _boxes(rng, 100).reshape(2, 50, 7)
    assert_close(anchor_head.get_direction_target(t(anchors), t(pred), 0.78539, 2),
                 jhead.get_direction_target(anchors, pred, 0.78539, 2), atol=0)


@pytest.mark.parametrize("max_half_extent", [32, 48])
def test_occupancy_target_and_loss_match_jax(max_half_extent):
    """The rasterized BEV target of rotated boxes, a box wider than the
    footprint bound and a padding row, then the focal loss."""
    rng = np.random.RandomState(4)
    gt = _gt(rng, [(1, 2, 3), (1, 1)], m=5)
    gt[1, 2] = [8.13, 0.11, -0.8, 40.0, 2.0, 1.6, 0.4, 1]
    grid, pc, vox = (32, 32, 10), (0.0, -8.0, -3.0, 16.0, 8.0, 2.0), (0.5, 0.5, 0.5)
    ref = np.asarray(jax_rasterize(jnp.asarray(gt), grid, pc, vox, max_half_extent))
    got = rasterize_gt_boxes_bev(t(gt), grid, pc, vox, max_half_extent)
    assert ref.sum() > 50
    np.testing.assert_array_equal(got.numpy(), ref)
    occ = rng.uniform(0.01, 0.99, (2, 32, 32, 1)).astype(np.float32)
    assert_close(occupancy_loss(t(occ), t(gt), grid, pc, vox, max_half_extent),
                 jax_occupancy_loss(occ, gt, grid, pc, vox, max_half_extent), atol=0, rtol=1e-5)


def test_onecycle_schedules_match_jax():
    steps = np.array([0, 1, 7, 39, 40, 41, 77, 99, 100, 130], np.float32)
    lr = optim.onecycle_lr_schedule(100, 3e-3, 10, 0.4)
    mom = optim.onecycle_mom_schedule(100, (0.95, 0.85), 0.4)
    # near the end of the cycle cos(pi pct) + 1 cancels in f32: atol 1e-9 (lr 3e-3)
    assert_close(lr(t(steps)), joptim.onecycle_lr_schedule(100, 3e-3, 10, 0.4)(steps),
                 atol=1e-9, rtol=1e-6)
    assert_close(mom(t(steps)), joptim.onecycle_mom_schedule(100, [0.95, 0.85], 0.4)(steps),
                 atol=0, rtol=1e-6)
    assert_close(optim.annealing_cos(1.0, 3.0, t(steps / 130)),
                 joptim.annealing_cos(1.0, 3.0, steps / 130), atol=1e-6)


def test_optimizer_matches_optax():
    """The adam_onecycle chain on a small tree with a frozen backbone: the
    global-norm clip (on the trainable leaves only; step 2's gradients are
    large enough to trigger it), AdamW with the momentum schedule as beta1,
    its bias correction, the decoupled weight decay, and no update, decay or
    state for the frozen leaves."""
    rng = np.random.RandomState(5)
    shapes = {"ddn_backbone": {"w": (4, 3)}, "head": {"w": (5, 3), "b": (5,)},
              "neck": {"w": (2, 2, 3)}}
    params = {m: {k: rng.randn(*s).astype(np.float32) for k, s in d.items()}
              for m, d in shapes.items()}
    tx, _ = joptim.build_optimizer(ConfigDict(dict(OPTIM_CFG)), 20, params)
    state = tx.init(params)

    # the port's module tree: the frozen leaf under the DDN backbone's name
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
    opt, _ = optim.build_optimizer(dict(OPTIM_CFG), 20, module)
    frozen = leaf[("ddn_backbone", "w")]
    assert not frozen.requires_grad and len(opt.params) == 3
    p_ref = params
    for step in range(4):
        scale = 30.0 if step == 2 else 1.0
        grads = {m: {k: (scale * rng.randn(*s)).astype(np.float32) for k, s in d.items()}
                 for m, d in shapes.items()}
        upd, state = tx.update(grads, state, p_ref)
        p_ref = optax.apply_updates(p_ref, upd)
        index = {id(p): mk for mk, p in leaf.items()}
        opt.step([t(grads[index[id(p)][0]][index[id(p)][1]]) for p in opt.params])
        for (m, k), p in leaf.items():
            assert_close(p, p_ref[m][k], atol=1e-7, rtol=1e-6, err_msg=f"step {step} {m}.{k}")
    np.testing.assert_array_equal(frozen.detach().numpy(), params["ddn_backbone"]["w"])
    # adam and sgd are ported (tests/test_torch_optim_remat.py); others refused
    with pytest.raises(NotImplementedError, match="lamb"):
        optim.build_optimizer({**dict(OPTIM_CFG), "OPTIMIZER": "lamb"}, 20, module)
