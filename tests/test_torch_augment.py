"""The port's data augmentor against the JAX package's, on the CPU: each of
the four ops the HGSFusion configs list, and ``DataAugmentor.forward`` on
``configs/hgsfusion_vod.yaml``'s list, on frames of a synthetic VoD tree with
the same ``np.random`` seed on both sides. Both are numpy, so every array
must be bit-equal."""
import copy

import numpy as np
import pytest

from hgsfusion_tpu.config import ConfigDict
from hgsfusion_tpu.datasets import build_dataset as jax_build_dataset
from hgsfusion_tpu.datasets.augmentor import DataAugmentor as JaxAugmentor
from hgsfusion_tpu_torch.config import vod_dataset_config
from hgsfusion_tpu_torch.datasets import build_dataset
from hgsfusion_tpu_torch.datasets.augmentor import PORTED, DataAugmentor
from hgsfusion_tpu_torch.datasets.synthetic import make_synthetic_kitti
from hgsfusion_tpu_torch.tools.create_infos import create_infos
from test_torch_data import _assert_tree_equal
from torch_parity import one_torch_thread  # noqa: F401

AUG = vod_dataset_config("")["DATA_CONFIG"]["DATA_AUGMENTOR"]
CLASSES = ["Car", "Pedestrian", "Cyclist"]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Three raw frames (before ``prepare_data``) of a structured tree at
    128x256, read by each package with its own calibration class; frame 2
    gets a box of a class outside CLASS_NAMES, which the mask drops."""
    root = tmp_path_factory.mktemp("aug") / "data"
    make_synthetic_kitti(root, num_frames=3, num_points=256, num_virtual=64,
                         image_hw=(128, 256), structured=True)
    cfg = vod_dataset_config(root)["DATA_CONFIG"]
    cfg.update(VIRTUAL_POINT_PREFIX="virtual_points", IMAGE_SIZE=[128, 256])
    create_infos(cfg, CLASSES)
    port = build_dataset(cfg, CLASSES, training=False)
    ref = jax_build_dataset(ConfigDict(cfg), CLASSES, training=False)
    out = []
    for i in range(3):
        pair = [port.compose_input_dict(i), ref.compose_input_dict(i)]
        if i == 2:
            for d in pair:
                d["gt_names"] = np.array(list(d["gt_names"][:-1]) + ["Van"])
        out.append(pair)
    return out


def _run(aug_cls, frame, seed, op=None, config=None, extra=None):
    d = {**copy.deepcopy({k: v for k, v in frame.items() if k != "calib"}),
         "calib": frame["calib"], **(extra or {})}
    aug = aug_cls(None, AUG, CLASSES)
    np.random.seed(seed)
    out = getattr(aug, op)(d, config) if op else aug.forward(d)
    out.pop("calib")
    return out, np.random.randint(1 << 30)  # the stream's position after the op


def _check(frame_pair, seed, **kw):
    got, got_next = _run(DataAugmentor, frame_pair[0], seed, **kw)
    want, want_next = _run(JaxAugmentor, frame_pair[1], seed, **kw)
    _assert_tree_equal(got, want)
    assert got_next == want_next  # the same number of draws
    return got


def _cfg(name):
    return next(c for c in AUG["AUG_CONFIG_LIST"] if c["NAME"] == name)


@pytest.mark.parametrize("seed", range(4))
def test_world_flip_matches_jax(frames, seed):
    """Both axes; over the seeds every flip is drawn on and off."""
    got = _check(frames[seed % 3], seed, op="random_world_flip",
                 config={"ALONG_AXIS_LIST": ["x", "y"]})
    assert {"flip_x", "flip_y"} <= set(got)


def test_world_flip_draws_both_ways():
    draws = set()
    for seed in range(4):
        np.random.seed(seed)
        draws |= {(bool(np.random.choice([False, True])), bool(np.random.choice([False, True])))}
    assert len(draws) >= 3  # test_world_flip_matches_jax covers flips on and off


@pytest.mark.parametrize("flip_x", [False, True])
def test_image_flip_fusion_matches_jax(frames, flip_x):
    got = _check(frames[0], 0, op="random_image_flip_fusion",
                 config=_cfg("random_image_flip_fusion"), extra={"flip_x": flip_x})
    unflipped = frames[0][0]["images"]
    assert np.array_equal(got["images"], unflipped[:, ::-1] if flip_x else unflipped)
    assert np.array_equal(got["gt_boxes"], frames[0][0]["gt_boxes"]) != flip_x


@pytest.mark.parametrize("op", ["random_world_rotation", "random_world_scaling"])
@pytest.mark.parametrize("seed", [0, 1])
def test_world_rotation_and_scaling_match_jax(frames, op, seed):
    got = _check(frames[seed], seed, op=op, config=_cfg(op))
    key = "noise_rot" if op == "random_world_rotation" else "noise_scale"
    assert got[key] != (0.0 if key == "noise_rot" else 1.0)


@pytest.mark.parametrize("seed", range(6))
def test_forward_matches_jax(frames, seed):
    """The hgsfusion_vod.yaml list: flip, image flip, rotation, scaling, the
    heading wrapped into [-pi, pi), then the class mask."""
    i = seed % 3
    mask = np.array([n in CLASSES for n in frames[i][0]["gt_names"]])
    got = _check(frames[i], seed, extra={"gt_boxes_mask": mask})
    assert len(got["gt_boxes"]) == mask.sum() == len(got["gt_names"])
    assert np.all(got["gt_boxes"][:, 6] >= -np.pi) and np.all(got["gt_boxes"][:, 6] < np.pi)


# the ops no HGSFusion config lists: all but the database sampler (ROADMAP
# queue 1 item 9) are ported (their parity: tests/test_torch_augment_zoo.py)
ZOO_OPS = ["gt_sampling", "random_world_translation", "random_local_translation",
           "random_local_rotation", "random_local_scaling", "random_world_frustum_dropout",
           "random_local_frustum_dropout", "random_local_pyramid_aug", "random_image_flip",
           "imgaug"]


@pytest.mark.parametrize("name", ZOO_OPS)
def test_unported_op_raises_unless_disabled(name):
    """An unported op raises at construction, a ported one is queued; either
    is dropped when disabled."""
    cfg = {"DISABLE_AUG_LIST": [], "AUG_CONFIG_LIST": [{"NAME": name}]}
    if name in PORTED:
        assert [c["NAME"] for _, c in DataAugmentor(None, cfg, CLASSES).queue] == [name]
    else:
        with pytest.raises(NotImplementedError, match="queue 1 item 9"):
            DataAugmentor(None, cfg, CLASSES)
    assert DataAugmentor(None, {**cfg, "DISABLE_AUG_LIST": [name]}, CLASSES).queue == []
    assert (name in PORTED) == (name != "gt_sampling")


def test_wide_boxes_and_roi_boxes_raise(frames):
    d = copy.deepcopy({k: v for k, v in frames[0][0].items() if k != "calib"})
    aug = DataAugmentor(None, AUG, CLASSES)
    wide = {**d, "gt_boxes": np.zeros((2, 9), np.float32)}
    with pytest.raises(NotImplementedError, match="7-column"):
        aug.forward(wide)
    with pytest.raises(NotImplementedError, match="roi_boxes"):
        aug.forward({**d, "roi_boxes": np.zeros((1, 2, 7), np.float32)})
