"""The augmentor ops that no HGSFusion config enables, against the JAX
package's, on the CPU: each op on frames of a synthetic VoD tree with the
same ``np.random`` seed on both sides, every array bit-equal and the stream
left at the same position (``test_torch_augment._check``). ``imgaug`` runs
on a stack of camera images."""
import copy

import numpy as np
import pytest

from hgsfusion_tpu.datasets.augmentor import DataAugmentor as JaxAugmentor
from hgsfusion_tpu_torch.datasets.augmentor import PORTED, DataAugmentor
from test_torch_augment import AUG, CLASSES, _check, frames  # noqa: F401
from test_torch_data import _assert_tree_equal
from torch_parity import one_torch_thread  # noqa: F401

PYRAMID = {"DROP_PROB": 0.3, "SPARSIFY_PROB": 0.6, "SPARSIFY_MAX_NUM": 3, "SWAP_PROB": 1.0,
           "SWAP_MAX_NUM": 1}
# (op, config, seeds): every op of the JAX registry the HGSFusion configs
# leave out, but the database sampler (queue 1 item 9)
CASES = [
    ("random_world_translation", {"NOISE_TRANSLATE_STD": [0.5, 0.5, 0.2]}, (0, 1)),
    ("random_local_translation", {"LOCAL_TRANSLATION_RANGE": [-0.4, 0.4],
                                  "ALONG_AXIS_LIST": ["x", "y", "z"]}, (0, 1)),
    ("random_local_rotation", {"LOCAL_ROT_ANGLE": [-0.3, 0.3]}, (0, 1)),
    ("random_local_rotation", {"LOCAL_ROT_ANGLE": 0.2}, (2,)),
    ("random_local_scaling", {"LOCAL_SCALE_RANGE": [0.9, 1.1]}, (0, 1)),
    ("random_world_frustum_dropout", {"INTENSITY_RANGE": [0.0, 0.2],
                                      "DIRECTION": ["top", "bottom", "left", "right"]}, (0, 1)),
    ("random_local_frustum_dropout", {"INTENSITY_RANGE": [0.0, 0.5],
                                      "DIRECTION": ["top", "bottom", "left", "right"]}, (0, 1)),
    ("random_local_pyramid_aug", PYRAMID, (0, 1, 2, 3)),
    ("random_image_flip", {"ALONG_AXIS_LIST": ["horizontal"], "PROB": 0.5}, (0, 1, 2, 3)),
]


@pytest.mark.parametrize("op,config,seed", [(op, c, s) for op, c, seeds in CASES
                                            for s in seeds])
def test_op_matches_jax(frames, op, config, seed):  # noqa: F811
    got = _check(frames[seed % 3], seed, op=op, config=copy.deepcopy(config))
    assert len(got["points"]) and got["gt_boxes"].shape[1] == 7


def test_world_translation_reaches_the_aug_matrix(frames):  # noqa: F811
    from hgsfusion_tpu_torch.datasets.dataset import DatasetTemplate

    got = _check(frames[0], 5, op="random_world_translation",
                 config={"NOISE_TRANSLATE_STD": [0.5, 0.5, 0.2]})
    m = DatasetTemplate.set_lidar_aug_matrix(dict(got))["lidar_aug_matrix"]
    np.testing.assert_array_equal(m[:3, 3], got["noise_translate"])


def test_pyramid_aug_moves_points(frames):  # noqa: F811
    """The stages change the cloud: the dropout and the sparsification
    shrink it, the swap moves points between boxes."""
    changed = [not np.array_equal(_check(frames[s % 3], s, op="random_local_pyramid_aug",
                                         config=dict(PYRAMID))["points"], frames[s % 3][0]["points"])
               for s in range(4)]
    assert all(changed)


def _camera_stack(seed):
    rng = np.random.RandomState(seed)
    return {"camera_imgs": rng.randint(0, 255, (3, 24, 40, 3)).astype(np.uint8),
            "points": rng.rand(8, 5).astype(np.float32),
            "gt_boxes": np.zeros((0, 7), np.float32)}


@pytest.mark.parametrize("seed,rand_flip", [(0, True), (1, True), (2, False)])
def test_imgaug_matches_jax(seed, rand_flip):
    config = {"NAME": "imgaug", "ROT_LIM": [-5.4, 5.4], "RAND_FLIP": rand_flip}
    outs = []
    for cls in (DataAugmentor, JaxAugmentor):
        d = _camera_stack(seed)
        np.random.seed(seed)
        out = cls(None, AUG, CLASSES).imgaug(d, config)
        outs.append((out, np.random.randint(1 << 30)))
    _assert_tree_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
    assert outs[0][0]["camera_imgs"].dtype == np.uint8
    assert not np.array_equal(outs[0][0]["camera_imgs"], _camera_stack(seed)["camera_imgs"])


def test_every_registry_op_but_the_sampler_is_ported():
    """The JAX registry's ops (its DataAugmentor's public methods): all
    ported but ``gt_sampling``, which raises at construction."""
    registry = {n for n in vars(JaxAugmentor) if not n.startswith("_")} - {"forward"}
    assert registry - set(PORTED) == {"gt_sampling"}
    with pytest.raises(NotImplementedError, match="gt_sampling.*item 9"):
        DataAugmentor(None, {"AUG_CONFIG_LIST": [{"NAME": "gt_sampling"}]}, CLASSES)
