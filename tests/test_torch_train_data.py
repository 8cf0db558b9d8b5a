"""The port's training data path against the JAX package's, on the CPU:
``build_dataset(..., training=True)`` frames (augmented, with their
``lidar_aug_matrix``) and collated batches under one ``np.random`` seed, the
redraw of a frame left without gt boxes, and ``PrefetchLoader``'s batches
and schedule. Every array must be bit-equal."""
import threading

import numpy as np
import pytest

from hgsfusion_tpu.config import ConfigDict
from hgsfusion_tpu.datasets import build_dataset as jax_build_dataset
from hgsfusion_tpu.datasets.loader import PrefetchLoader as JaxLoader
from hgsfusion_tpu_torch.config import vod_dataset_config
from hgsfusion_tpu_torch.datasets import build_dataset
from hgsfusion_tpu_torch.datasets.loader import PrefetchLoader
from hgsfusion_tpu_torch.datasets.synthetic import make_synthetic_kitti
from hgsfusion_tpu_torch.tools.create_infos import create_infos
from test_torch_data import _assert_tree_equal
from torch_parity import one_torch_thread  # noqa: F401

CLASSES = ["Car", "Pedestrian", "Cyclist"]


def _tree(root, frames, empty=()):
    """A structured tree at 128x256 with the hgsfusion_vod.yaml data config;
    the frames in ``empty`` carry only boxes of a class outside
    CLASS_NAMES."""
    make_synthetic_kitti(root, num_frames=frames, num_points=256, num_virtual=64,
                         image_hw=(128, 256), structured=True)
    for i in empty:
        label = root / "training" / "label_2" / f"{i:05d}.txt"
        label.write_text("".join("Van" + ln[ln.index(" "):] + "\n"
                                 for ln in label.read_text().splitlines()))
    cfg = vod_dataset_config(root)["DATA_CONFIG"]
    cfg.update(VIRTUAL_POINT_PREFIX="virtual_points", IMAGE_SIZE=[128, 256])
    create_infos(cfg, CLASSES)
    return cfg


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _tree(tmp_path_factory.mktemp("train") / "data", 4)


def _both(cfg):
    return (build_dataset(cfg, CLASSES, training=True),
            jax_build_dataset(ConfigDict(cfg), CLASSES, training=True))


@pytest.mark.parametrize("seed", [0, 3])
def test_training_frames_and_batches_match_jax(tree, seed):
    port, ref = _both(tree)
    assert len(port) == len(ref) == 4
    np.random.seed(seed)
    got = [port[i] for i in range(4)]
    np.random.seed(seed)
    want = [ref[i] for i in range(4)]
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_tree_equal(g, w, f"frame {i}")
    _assert_tree_equal(port.collate_batch(got), ref.collate_batch(want), "batch")
    # the augmentations ran: some frame rotated (a non-identity matrix), and
    # the matrix carries no x-flip (recorded only with flip_y)
    assert any(not np.array_equal(g["lidar_aug_matrix"], np.eye(4)) for g in got)
    assert all("flip_x" in g and "flip_y" not in g for g in got)
    for g in got:
        rot = np.arctan2(g["lidar_aug_matrix"][1, 0], g["lidar_aug_matrix"][0, 0])
        assert abs(rot - g["noise_rot"]) < 1e-6


def test_frame_without_gt_is_redrawn_as_jax(tmp_path):
    cfg = _tree(tmp_path / "data", 3, empty=(1,))
    port, ref = _both(cfg)
    for seed in range(3):
        np.random.seed(seed)
        got = port[1]
        np.random.seed(seed)
        want = ref[1]
        _assert_tree_equal(got, want)
        assert got["frame_id"] != "00001"
        assert (got["gt_boxes"][:, -1] > 0).any()


def test_loader_matches_jax_without_workers(tree):
    """B=2 over 4 frames: 3 batches cross an epoch boundary."""
    out = []
    for loader_cls, build in ((PrefetchLoader, build_dataset), (JaxLoader, None)):
        ds = (build(tree, CLASSES, training=True) if build
              else jax_build_dataset(ConfigDict(tree), CLASSES, training=True))
        np.random.seed(7)
        it = loader_cls(ds, 2, shuffle=True, num_workers=0).batches()
        out.append([next(it) for _ in range(3)])
        it.close()
    for i, (g, w) in enumerate(zip(*out)):
        _assert_tree_equal(g, w, f"batch {i}")


class Indexed:
    """A dataset whose sample is its index; ``fail_at`` raises there."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f"cannot build sample {i}")
        return {"i": np.array([i])}

    @staticmethod
    def collate_batch(samples):
        return {"i": np.concatenate([s["i"] for s in samples])}


def _schedule(loader_cls, workers, batches=12, **kw):
    np.random.seed(11)
    it = loader_cls(Indexed(7), 3, shuffle=True, num_workers=workers, **kw).batches()
    out = [next(it)["i"].tolist() for _ in range(batches)]
    it.close()
    return out


@pytest.mark.parametrize("workers", [2, 5])
def test_loader_schedule_with_workers(workers):
    before = threading.active_count()
    got = _schedule(PrefetchLoader, workers)
    assert threading.active_count() == before  # closing the stream stopped its threads
    assert got == _schedule(PrefetchLoader, 0) == _schedule(JaxLoader, 0)
    # 7 frames, B=3: two batches per epoch, a fresh permutation each epoch
    for e in range(6):
        epoch = got[2 * e] + got[2 * e + 1]
        assert len(set(epoch)) == 6 and set(epoch) <= set(range(7))
    assert got[0:2] != got[2:4]


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_worker_error_surfaces(workers):
    np.random.seed(0)
    loader = PrefetchLoader(Indexed(7, fail_at=3), 1, shuffle=False, num_workers=workers)
    it = loader.batches()
    assert [next(it)["i"].tolist() for _ in range(3)] == [[0], [1], [2]]
    with pytest.raises((RuntimeError, ValueError)) as err:
        next(it)
    exc = err.value if workers == 0 else err.value.__cause__
    assert isinstance(exc, ValueError) and "sample 3" in str(exc)
