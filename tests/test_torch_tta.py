"""The port's test-time augmentation (``eval/tta.py``,
``tools/test_tta.py``) against the JAX package's, on the CPU.

The variants of a padded VoD frame (flip, image-flip fusion, rotation,
scaling from one ``RandomState(seed)``, then the ``lidar_aug_matrix``) equal
JAX's bit for bit for several seeds, with the image in the sample and
without it; the CLI's augmented gt annotations equal the JAX CLI's
construction on the same variants, and the CLI scores ``tta_num`` x frames
annotations with the VoD protocol.
"""
import dataclasses

import numpy as np
import pytest

from hgsfusion_tpu.config import ConfigDict
from hgsfusion_tpu.datasets import build_dataset as jax_build_dataset
from hgsfusion_tpu.eval.tta import make_tta_variants as jax_make_tta_variants
from hgsfusion_tpu.utils import box_utils as jax_box_utils
from hgsfusion_tpu_torch.config import load_config, model_config_from_yaml
from hgsfusion_tpu_torch.datasets import build_dataset
from hgsfusion_tpu_torch.datasets.synthetic import make_synthetic_kitti
from hgsfusion_tpu_torch.eval.tta import make_tta_variants
from hgsfusion_tpu_torch.models.detector import HGSFusionModel
from hgsfusion_tpu_torch.tools import test_tta
from hgsfusion_tpu_torch.tools.create_infos import create_infos
from hgsfusion_tpu_torch.utils.common import create_logger
from test_torch_data import _assert_tree_equal
from test_torch_eval import _tiny_cfg
from torch_parity import one_torch_thread  # noqa: F401

TTA_NUM = 3
SEEDS = (0, 1, 2, 3, 5, 8)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A structured 3-frame tree (64x96) under the cut VoD config, both
    packages' datasets on it, and frame 1's padded sample with its gt."""
    root = tmp_path_factory.mktemp("tta") / "data"
    make_synthetic_kitti(root, num_frames=3, num_points=256, num_virtual=64,
                         image_hw=(64, 96), structured=True)
    cfg = _tiny_cfg(load_config("configs/hgsfusion_vod.yaml"), root)
    create_infos(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"])
    ds = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False)
    jds = jax_build_dataset(ConfigDict(cfg["DATA_CONFIG"]), cfg["CLASS_NAMES"], training=False)
    sample = ds.pad_to_static(ds.prepare_data(ds.compose_input_dict(1)))
    jsample = jds.pad_to_static(jds.prepare_data(jds.compose_input_dict(1)))
    assert (sample["gt_boxes"][:, -1] > 0).sum() >= 2
    return {"cfg": cfg, "ds": ds, "jds": jds, "sample": sample, "jsample": jsample,
            "calib": ds.get_calib("00001"), "jcalib": jds.get_calib("00001")}


def _equal(got, want, where):
    assert set(got) == set(want), where
    for k, v in want.items():
        g = got[k]
        if isinstance(v, np.ndarray):
            assert g.dtype == v.dtype and g.shape == v.shape, (where, k)
            np.testing.assert_array_equal(g, v, err_msg=f"{where} {k}")
        elif k != "calib":
            assert g == v, (where, k)


@pytest.mark.parametrize("with_image", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_variants_match_jax_bit_for_bit(setup, seed, with_image):
    sample, jsample = dict(setup["sample"]), dict(setup["jsample"])
    if not with_image:
        sample.pop("images")
        jsample.pop("images")
    got = make_tta_variants(sample, setup["calib"], TTA_NUM, seed=seed)
    want = jax_make_tta_variants(jsample, setup["jcalib"], TTA_NUM, seed=seed)
    assert len(got) == len(want) == TTA_NUM
    for i, (g, w) in enumerate(zip(got, want)):
        _equal(g, w, f"seed {seed} variant {i}")
    # both inputs are left as they were (and equal)
    _equal(sample, jsample, "input")


def test_seeds_cover_every_augmentation(setup):
    """Over SEEDS some variant is flipped (its image mirrored) and some is
    not, every one rotated and scaled."""
    flipped = 0
    for seed in SEEDS:
        for v in make_tta_variants(setup["sample"], setup["calib"], TTA_NUM, seed=seed):
            mirrored = np.array_equal(v["images"], setup["sample"]["images"][:, ::-1])
            flipped += mirrored
            assert not np.array_equal(v["points"], setup["sample"]["points"])
    assert 0 < flipped < len(SEEDS) * TTA_NUM


def _jax_gt_anno(batch, calib, class_names):
    """The augmented gt annotation as the JAX package's tools/test_tta.py
    builds it."""
    gt = np.asarray(batch["gt_boxes"][0])
    gt = gt[gt[:, -1] > 0]
    cam = jax_box_utils.boxes3d_lidar_to_kitti_camera(gt[:, :7], calib)
    bbox = jax_box_utils.boxes3d_kitti_camera_to_imageboxes(
        cam, calib, image_shape=np.asarray(batch["image_shape"][0]).reshape(-1))
    names = np.array([class_names[int(c) - 1] for c in gt[:, -1]])
    return {"name": names, "location": cam[:, 0:3], "dimensions": cam[:, 3:6],
            "rotation_y": cam[:, 6], "bbox": bbox, "alpha": np.zeros(len(gt)),
            "occluded": np.zeros(len(gt)), "truncated": np.zeros(len(gt)),
            "difficulty": np.zeros(len(gt), np.int32)}


def test_cli_scores_each_variant_against_its_augmented_gt(setup, tmp_path):
    cfg, jds = setup["cfg"], setup["jds"]
    model = HGSFusionModel(dataclasses.replace(model_config_from_yaml(cfg), score_thresh=0.0),
                           device="cpu", seed=5)
    det, gt, result, launches = test_tta.run_tta(model, setup["ds"], create_logger(),
                                                 tta_num=TTA_NUM, max_frames=2)
    assert len(det) == len(gt) == len(launches) == 2 * TTA_NUM
    assert all(len(a["name"]) > 0 for a in det)
    assert "entire_area/mAP_3d" in result
    for i in range(2):
        jsample = jds.pad_to_static(jds.prepare_data(jds.compose_input_dict(i)))
        jcalib = jds.get_calib(f"{i:05d}")
        for v, variant in enumerate(jax_make_tta_variants(jsample, jcalib, TTA_NUM, seed=i)):
            want = _jax_gt_anno(jds.collate_batch([variant]), jcalib, jds.class_names)
            _assert_tree_equal(gt[i * TTA_NUM + v], want, f"frame {i} variant {v}")
