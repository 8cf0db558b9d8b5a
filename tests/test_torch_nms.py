"""Rotated greedy NMS as one op (``ops/library.py``: ``hgsfusion::nms_lazy``,
``ops/nms.py``) against the JAX package's ``greedy_nms_lazy``, on the CPU,
where the op takes its plain version; the plain form of the kernels' two
phases (``nms_mask_plain``, ``nms_sweep_plain``) against the same;
``torch.library.opcheck`` of the three ops of the served graph; the batched
``class_agnostic_nms`` and ``post_process`` against their frames one by one.
The kernels themselves (``csrc/nms_lazy.cu``) are held to the plain versions
in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import clustered_boxes, degenerate_boxes
from hgsfusion_tpu.ops.nms import greedy_nms_lazy as jax_greedy_nms_lazy
from hgsfusion_tpu_torch.config import HGSFusionConfig
from hgsfusion_tpu_torch.models.anchors import flatten_anchors, generate_anchors
from hgsfusion_tpu_torch.models.detector import post_process
from hgsfusion_tpu_torch.ops import library, nms
from hgsfusion_tpu_torch.ops.nms import class_agnostic_nms, greedy_nms_lazy_plain
from hgsfusion_tpu_torch.ops.rotated_iou import boxes_iou_bev
from hgsfusion_tpu_torch.utils.box_coder import ResidualCoder
from torch_parity import one_torch_thread  # noqa: F401

K = 384


def _random_boxes(rng, k):
    b = np.zeros((k, 7), np.float32)
    b[:, 0:2] = rng.uniform(0, 20, (k, 2))
    b[:, 2] = rng.uniform(-2, 0, k)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (k, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, k)
    return b


def _case(name):
    """(boxes (B, K, 7), valid (B, K), max_keep) of one named case."""
    rng = np.random.RandomState(7)
    allv = np.ones((1, K), bool)
    if name == "random":
        return _random_boxes(rng, K)[None], allv, 500
    if name == "clusters":
        return clustered_boxes(K, 40, 0)[None], allv, 500
    if name == "duplicates":
        return degenerate_boxes(K, 3)[None], allv, 500
    if name == "none_valid":
        return clustered_boxes(K, 40, 0)[None], np.zeros((1, K), bool), 500
    if name == "max_keep":
        return clustered_boxes(K, 40, 0)[None], allv, 9
    if name == "some_valid":
        return clustered_boxes(K, 40, 1)[None], rng.rand(1, K) < 0.3, 500
    if name == "batch2":
        boxes = np.stack([clustered_boxes(K, 40, 2), _random_boxes(rng, K)])
        return boxes, np.stack([rng.rand(K) < 0.5, np.ones(K, bool)]), 500
    raise KeyError(name)


CASES = ["random", "clusters", "duplicates", "none_valid", "max_keep", "some_valid", "batch2"]


@pytest.mark.parametrize("name", CASES)
def test_op_matches_jax(name):
    """The op's keep sets (one call for the batch) and the plain version's
    (frame by frame) equal JAX's ``greedy_nms_lazy`` at 0.01."""
    boxes, valid, max_keep = _case(name)
    got = library.nms_lazy_op(torch.from_numpy(boxes), torch.from_numpy(valid), 0.01, max_keep)
    assert got.dtype == torch.bool and got.shape == valid.shape
    for i in range(boxes.shape[0]):
        want = np.asarray(jax_greedy_nms_lazy(jnp.asarray(boxes[i]), jnp.asarray(valid[i]),
                                              0.01, max_keep))
        np.testing.assert_array_equal(got[i].numpy(), want, err_msg=f"frame {i}")
        plain = greedy_nms_lazy_plain(torch.from_numpy(boxes[i]), torch.from_numpy(valid[i]),
                                      0.01, max_keep)
        np.testing.assert_array_equal(plain.numpy(), want, err_msg=f"frame {i}")
    kept = got.sum(1)
    assert bool((kept <= max_keep).all())
    if name == "none_valid":
        assert int(kept.sum()) == 0
    elif name == "max_keep":
        assert int(kept[0]) == max_keep
    else:
        assert int(kept.min()) > 1


# the two-phase form beyond CASES: K not a multiple of the mask's 64-candidate
# tiles, max_keep at a tile boundary, and a negative threshold (every later
# valid candidate suppressed)
TWO_PHASE_CASES = CASES + ["k301", "keep63", "keep64", "keep65", "negative"]


def _two_phase_case(name):
    """(boxes (B, K, 7), valid (B, K), max_keep, nms_thresh)."""
    if name in CASES:
        return (*_case(name), 0.01)
    rng = np.random.RandomState(13)
    if name == "k301":
        return clustered_boxes(301, 30, 4)[None], rng.rand(1, 301) < 0.8, 500, 0.01
    if name.startswith("keep"):  # about 160 survive 0.01 at 200 clusters
        return clustered_boxes(K, 200, 6)[None], np.ones((1, K), bool), int(name[4:]), 0.01
    if name == "negative":
        return clustered_boxes(K, 40, 0)[None], rng.rand(1, K) < 0.5, 500, -0.5
    raise KeyError(name)


@pytest.mark.parametrize("name", TWO_PHASE_CASES)
def test_two_phase_plain_matches_jax(name):
    """``nms_sweep_plain`` over ``nms_mask_plain`` keeps what JAX's
    ``greedy_nms_lazy`` and ``greedy_nms_lazy_plain`` keep."""
    boxes, valid, max_keep, thresh = _two_phase_case(name)
    for i in range(boxes.shape[0]):
        b, v = torch.from_numpy(boxes[i]), torch.from_numpy(valid[i])
        want = np.asarray(jax_greedy_nms_lazy(jnp.asarray(boxes[i]), jnp.asarray(valid[i]),
                                              thresh, max_keep))
        got = nms.nms_sweep_plain(nms.nms_mask_plain(b, v, thresh), v, max_keep)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"frame {i}")
        np.testing.assert_array_equal(greedy_nms_lazy_plain(b, v, thresh, max_keep).numpy(),
                                      want, err_msg=f"frame {i}")
        kept = int(got.sum())
        if name.startswith("keep"):
            assert kept == max_keep
        elif name == "negative":
            assert kept == 1
        elif name != "none_valid":
            assert kept > 1


@pytest.mark.parametrize("name", ["k301", "some_valid", "negative"])
def test_mask_plain_bits(name):
    """``nms_mask_plain``'s bits: set exactly where i < j are both valid and
    the plain IoU exceeds the threshold; and ``nms_sweep_plain`` reads only
    the words ``nms_mask`` writes (row tiles with a valid candidate, from
    their own tile on): filling the others with random bits keeps the keep
    set."""
    boxes, valid, max_keep, thresh = _two_phase_case(name)
    b, v = torch.from_numpy(boxes[0]), torch.from_numpy(valid[0])
    k = v.shape[0]
    mask = nms.nms_mask_plain(b, v, thresh)
    tiles = -(-k // 64)
    assert mask.shape == (k, tiles) and mask.dtype == torch.int64
    bits = ((mask[..., None] >> torch.arange(64)) & 1).bool().view(k, -1)[:, :k]
    idx = torch.arange(k)
    want = (boxes_iou_bev(b, b) > thresh) & v[:, None] & v[None, :] & (idx[None] > idx[:, None])
    assert torch.equal(bits, want)
    rng = np.random.RandomState(2)
    row_tile_valid = torch.zeros(tiles, dtype=torch.bool).index_fill_(
        0, torch.unique(idx[v] // 64), True)
    before_own_tile = torch.arange(tiles)[None] < idx[:, None] // 64
    unwritten = ~row_tile_valid[idx // 64][:, None] | before_own_tile
    noise = torch.from_numpy(rng.randint(-2**62, 2**62, (k, tiles), dtype=np.int64))
    noisy = torch.where(unwritten, noise, mask)
    assert bool((noisy != mask).any())
    keep = nms.nms_sweep_plain(mask, v, max_keep)
    assert torch.equal(nms.nms_sweep_plain(noisy, v, max_keep), keep)


def test_op_rejects_what_it_does_not_take():
    boxes, valid, _ = _case("random")
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    with pytest.raises(ValueError, match="bad shapes"):
        library.nms_lazy_op(b[0], v[0], 0.01, 5)
    with pytest.raises(TypeError, match="float32"):
        library.nms_lazy_op(b.double(), v, 0.01, 5)
    with pytest.raises(TypeError, match="bool"):
        library.nms_lazy_op(b, v.int(), 0.01, 5)
    with pytest.raises(ValueError, match="max_keep"):
        library.nms_lazy_op(b, v, 0.01, -1)
    with pytest.raises(ValueError, match="CUDA"):  # the launch wrapper takes no CPU tensor
        library.nms_lazy(b, v, 0.01, 5)


def _opcheck_args():
    rng = np.random.RandomState(3)
    feats = torch.from_numpy(rng.randn(1, 5, 7, 8).astype(np.float32))
    grid = torch.from_numpy(rng.uniform(-1.1, 1.1, (1, 3, 4, 2, 3)).astype(np.float32))
    maps = [feats, torch.from_numpy(rng.randn(1, 3, 4, 6).astype(np.float32))]
    kmat = torch.from_numpy(rng.randn(14, 5).astype(np.float32))
    bias = torch.from_numpy(rng.randn(5).astype(np.float32))
    boxes, valid, _ = _case("batch2")
    return {
        "quad_sample_fwd": (library.quad_sample_op, (feats, grid[..., 0:2])),
        "quad_sample_reduce_fwd": (library.quad_sample_reduce_op,
                                   (grid[..., 0:2], maps, [0, 8], kmat, bias)),
        "nms_lazy": (library.nms_lazy_op, (torch.from_numpy(boxes[:, :64].copy()),
                                           torch.from_numpy(valid[:, :64].copy()), 0.1, 20)),
    }


@pytest.mark.parametrize("op", ["quad_sample_fwd", "quad_sample_reduce_fwd", "nms_lazy"])
def test_opcheck(op):
    """Schema, fake implementation (shapes, dtypes, strides) and tracing of
    each op of the served graph, on its CPU implementation."""
    fn, args = _opcheck_args()[op]
    torch.library.opcheck(fn, args)
    out = fn(*args)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = fn(*[mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else [mode.from_tensor(t) for t in a] if isinstance(a, list) and a
                    and isinstance(a[0], torch.Tensor) else a for a in args])
    assert (fake.shape, fake.dtype, fake.stride()) == (out.shape, out.dtype, out.stride())


def test_sampler_op_is_the_plain_version_on_the_cpu():
    fn, args = _opcheck_args()["quad_sample_fwd"]
    from hgsfusion_tpu_torch.ops.quad_sample import quad_sample_fwd_uv_plain
    assert torch.equal(fn(*args), quad_sample_fwd_uv_plain(*args)[0])
    fn, (uv, maps, offs, kmat, bias) = _opcheck_args()["quad_sample_reduce_fwd"]
    from hgsfusion_tpu_torch.ops.quad_sample import quad_sample_reduce_plain
    assert torch.equal(fn(uv, maps, offs, kmat, bias),
                       quad_sample_reduce_plain(uv, list(zip(maps, offs)), kmat, bias))


def test_class_agnostic_nms_batch_equals_frames(monkeypatch):
    """Two frames in one call (one NMS op) give each frame's own result."""
    rng = np.random.RandomState(11)
    boxes = torch.from_numpy(np.stack([clustered_boxes(300, 30, 5), _random_boxes(rng, 300)]))
    scores = torch.from_numpy(np.stack([rng.permutation(300), rng.permutation(300)])
                              .astype(np.float32) / 300)  # tie-free
    calls = []

    def spy(*a):
        calls.append(a[0].shape)
        return library.nms_lazy_op(*a)

    monkeypatch.setattr(nms, "nms_lazy_op", spy)
    idx, valid = class_agnostic_nms(scores, boxes, 0.2, 0.01, 200, 60)
    monkeypatch.undo()
    assert calls == [(2, 200, 7)] and idx.shape == valid.shape == (2, 60)
    for i in range(2):
        fi, fv = class_agnostic_nms(scores[i], boxes[i], 0.2, 0.01, 200, 60)
        assert torch.equal(valid[i], fv) and torch.equal(idx[i][fv], fi[fv])
        assert bool(fv.any())


def test_post_process_batch_equals_frames():
    """``post_process`` over a batch of two equals each frame alone (boxes,
    scores, labels bit for bit)."""
    cfg = HGSFusionConfig(pc_range=(0.0, -8.0, -3.0, 16.0, 8.0, 2.0),
                          voxel_size=(0.5, 0.5, 0.5), image_size=(64, 96))
    anchors = torch.from_numpy(flatten_anchors(
        generate_anchors(cfg.anchor_generator, cfg.grid_size, cfg.pc_range)[0]))
    nx, ny, _ = cfg.grid_size
    a_loc = cfg.num_anchors_per_location
    rng = np.random.RandomState(4)
    preds = {"cls_preds": rng.normal(-3.0, 1.5, (2, ny, nx, a_loc * 3)),
             "box_preds": rng.normal(0, 0.3, (2, ny, nx, a_loc * 7)),
             "dir_cls_preds": rng.normal(0, 1, (2, ny, nx, a_loc * 2))}
    preds = {k: torch.from_numpy(v.astype(np.float32)) for k, v in preds.items()}
    kw = dict(score_thresh=0.1, nms_thresh=0.1, pre_max_size=512, post_max_size=40)
    both = post_process(preds, anchors, ResidualCoder(), cfg, **kw)
    assert both["boxes"].shape == (2, 40, 7)
    for i in range(2):
        one = post_process({k: v[i:i + 1] for k, v in preds.items()}, anchors,
                           ResidualCoder(), cfg, **kw)
        assert bool(one["valid"].any())
        for k in one:
            assert torch.equal(both[k][i:i + 1], one[k]), k
