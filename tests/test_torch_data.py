"""The port's data layer against the JAX package's, on the CPU: the
synthetic KITTI tree, image I/O, info files, frames and batches, the
calibration and the numpy box geometry, and the VoD data config preset."""
import pickle
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from hgsfusion_tpu.config import ConfigDict
from hgsfusion_tpu.config import load_config as jax_load_config
from hgsfusion_tpu.datasets import build_dataset as jax_build_dataset
from hgsfusion_tpu.datasets.synthetic import make_synthetic_kitti as jax_make_synthetic
from hgsfusion_tpu.ops.points_in_boxes import points_in_boxes as jax_points_in_boxes
from hgsfusion_tpu.utils import box_utils as jax_box_utils
from hgsfusion_tpu.utils.calibration import Calibration as JaxCalibration
from hgsfusion_tpu.utils.calibration import calib_to_matricies as jax_calib_to_matricies
from hgsfusion_tpu_torch.config import load_config, vod_dataset_config
from hgsfusion_tpu_torch.datasets import build_dataset, image_io
from hgsfusion_tpu_torch.datasets.dataset import DatasetTemplate
from hgsfusion_tpu_torch.datasets.synthetic import make_synthetic_kitti
from hgsfusion_tpu_torch.ops.points_in_boxes import points_in_boxes
from hgsfusion_tpu_torch.tools.create_infos import create_infos
from hgsfusion_tpu_torch.utils import box_utils
from hgsfusion_tpu_torch.utils.calibration import Calibration, calib_to_matricies
from test_cli import _write_cfg
from torch_parity import one_torch_thread  # noqa: F401

SYNTH_CASES = {
    "noise_jpg": dict(num_frames=2, num_points=256, num_virtual=32),
    "structured_jpg": dict(num_frames=2, num_points=256, num_virtual=64, structured=True,
                           support_range=(0.2, 1.0)),
    "noise_png": dict(num_frames=1, num_points=128, num_virtual=16, image_ext=".png",
                      image_hw=(40, 72)),
}


def _files(root):
    return sorted(p.relative_to(root) for p in Path(root).rglob("*") if p.is_file())


@pytest.mark.parametrize("case", sorted(SYNTH_CASES))
def test_synthetic_tree_matches_jax(tmp_path, case):
    kw = SYNTH_CASES[case]
    jax_make_synthetic(tmp_path / "jax", **kw)
    make_synthetic_kitti(tmp_path / "port", **kw)
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port")
    for rel in files:
        a, b = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.suffix in (".jpg", ".png"):
            # the JAX package writes every image with Pillow; both decode to
            # the same pixels (the port's PNG writer uses other bytes)
            want = np.asarray(Image.open(a))
            got = image_io.read_image(b)
            assert got.shape == want.shape, rel
            np.testing.assert_array_equal(got, want, err_msg=str(rel))
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def _filtered_png(path, img, ftype):
    """A PNG of ``img`` with every row stored under filter ``ftype``."""
    depth = 16 if img.dtype == np.uint16 else 8
    pix = img[..., None] if img.ndim == 2 else img
    h, w, c = pix.shape
    rows = (pix.astype(">u2") if depth == 16 else pix).reshape(h, -1).view(np.uint8)
    rows = rows.astype(np.int64)
    bpp = c * depth // 8
    out = []
    prior = np.zeros(rows.shape[1], np.int64)
    for r in rows:
        a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        c_ = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(r)
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (a + prior) // 2
        else:
            p = a + prior - c_
            pa, pb, pc = np.abs(p - a), np.abs(p - prior), np.abs(p - c_)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c_))
        out.append(np.concatenate([[ftype], (r - pred) % 256]).astype(np.uint8))
        prior = r
    ctype = {1: 0, 3: 2}[c]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    Path(path).write_bytes(image_io.PNG_SIGNATURE
                           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
                           + chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
                           + chunk(b"IEND", b""))


def _pixels(kind, rng, h=11, w=13):
    if kind == "rgb8":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "grey16":
        return rng.randint(0, 65536, (h, w)).astype(np.uint16)
    return rng.randint(0, 256, (h, w)).astype(np.uint8)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["rgb8", "grey16"])
def test_png_row_filters_read_as_pillow(tmp_path, kind, ftype):
    img = _pixels(kind, np.random.RandomState(ftype))
    path = tmp_path / "f.png"
    _filtered_png(path, img, ftype)
    got = image_io.read_image(path)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(got, img)
    assert got.dtype == img.dtype


@pytest.mark.parametrize("kind", ["rgb8", "grey16", "grey8"])
def test_png_read_of_pillow_files(tmp_path, kind):
    """Pillow's writer chooses a filter per row; a smooth image with noise
    makes it use several."""
    rng = np.random.RandomState(1)
    ramp = np.add.outer(np.arange(40), np.arange(60)) * (3 if kind != "grey16" else 700)
    noise = _pixels(kind, rng, 40, 60) // 8
    img = (ramp.reshape(40, 60, *([1] if kind == "rgb8" else [])) + noise).astype(noise.dtype)
    path = tmp_path / "p.png"
    Image.fromarray(img).save(path)
    got = image_io.read_image(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(image_io.image_shape(path), [40, 60])


@pytest.mark.parametrize("kind", ["rgb8", "grey16"])
def test_png_round_trip(tmp_path, kind):
    img = _pixels(kind, np.random.RandomState(2), 17, 23)
    path = tmp_path / "r.png"
    image_io.write_image(path, img)
    got = image_io.read_image(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def _full_cfg(root):
    cfg = vod_dataset_config(root)
    cfg["DATA_CONFIG"]["VIRTUAL_POINT_PREFIX"] = "virtual_points"
    return cfg["DATA_CONFIG"], cfg["CLASS_NAMES"]


def _cli_cfg(root, tmp_path):
    _write_cfg(tmp_path / "tiny.yaml", root)
    cfg = load_config(tmp_path / "tiny.yaml")
    return cfg["DATA_CONFIG"], cfg["CLASS_NAMES"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One structured tree at 128x256 with infos written by the port."""
    root = tmp_path_factory.mktemp("vod") / "data"
    make_synthetic_kitti(root, num_frames=3, num_points=256, num_virtual=64,
                         image_hw=(128, 256), structured=True)
    data_cfg, names = _full_cfg(root)
    create_infos(data_cfg, names)
    return root


def _assert_tree_equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, JaxCalibration):
        for k in ("P2", "R0", "V2C"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=where)
    else:
        assert got == want, where


def test_create_infos_match_jax(tree, tmp_path):
    data_cfg, names = _full_cfg(tree)
    jax_ds = jax_build_dataset(ConfigDict(data_cfg), names, training=False)
    jax_ds.root_path = tmp_path  # write the JAX pickles beside, not over, the port's
    for sub in ("ImageSets", "training"):
        (tmp_path / sub).symlink_to(tree / sub)
    jax_ds.create_infos()
    for split in ("train", "val"):
        with open(tree / f"kitti_infos_{split}.pkl", "rb") as f:
            got = pickle.load(f)
        with open(tmp_path / f"kitti_infos_{split}.pkl", "rb") as f:
            want = pickle.load(f)
        _assert_tree_equal(got, want, split)


@pytest.mark.parametrize("which", ["hgsfusion_vod", "cli_small"])
def test_frames_and_batches_match_jax(tree, tmp_path, which):
    data_cfg, names = _full_cfg(tree) if which == "hgsfusion_vod" else _cli_cfg(tree, tmp_path)
    port = build_dataset(data_cfg, names, training=False)
    ref = jax_build_dataset(ConfigDict(data_cfg), names, training=False)
    assert len(port) == len(ref) == 3
    frames = [port[i] for i in range(3)]
    for i, f in enumerate(frames):
        _assert_tree_equal(f, ref[i], f"frame {i}")
    assert frames[0]["points_valid"].sum() > 0
    _assert_tree_equal(port.collate_batch(frames),
                       ref.collate_batch([ref[i] for i in range(3)]), "batch")


def _random_calib(rng):
    tr = np.concatenate([np.linalg.qr(rng.randn(3, 3))[0], rng.randn(3, 1)], axis=1)
    p2 = np.array([[700.0, 0, 960, 45], [0, 700, 250, -0.3], [0, 0, 1, 0.005]])
    p2[:, :3] += rng.uniform(-5, 5, (3, 3)) * [[1, 0, 1], [0, 1, 1], [0, 0, 0]]
    return {"P2": p2.astype(np.float32), "P3": p2.astype(np.float32),
            "R0": np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32),
            "Tr_velo2cam": tr.astype(np.float32)}


def _random_boxes(rng, n):
    return np.concatenate([rng.uniform(-20, 40, (n, 3)), rng.uniform(0.5, 5, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], axis=1).astype(np.float32)


GEOMETRY = ["calibration", "boxes_to_corners_3d", "mask_center", "mask_corners",
            "camera_to_lidar", "lidar_to_camera", "corners3d_kitti_camera",
            "camera_to_imageboxes", "points_in_boxes"]


@pytest.mark.parametrize("fn", GEOMETRY)
def test_geometry_matches_jax(fn):
    rng = np.random.RandomState(GEOMETRY.index(fn))
    calib_d = _random_calib(rng)
    calib, jcalib = Calibration(calib_d), JaxCalibration(calib_d)
    boxes = _random_boxes(rng, 40)
    pts = rng.uniform(-20, 40, (300, 3)).astype(np.float32)
    rng_lim = np.array([0, -25.6, -3, 51.2, 25.6, 2], np.float32)
    if fn == "calibration":
        pairs = [(calib.lidar_to_rect(pts), jcalib.lidar_to_rect(pts)),
                 (calib.rect_to_lidar(pts), jcalib.rect_to_lidar(pts)),
                 (calib.lidar_to_img(pts)[0], jcalib.lidar_to_img(pts)[0]),
                 (calib.lidar_to_img(pts)[1], jcalib.lidar_to_img(pts)[1]),
                 (calib.img_to_rect(pts[:, 0], pts[:, 1], pts[:, 2]),
                  jcalib.img_to_rect(pts[:, 0], pts[:, 1], pts[:, 2])),
                 *zip(calib_to_matricies(calib), jax_calib_to_matricies(jcalib))]
    elif fn == "boxes_to_corners_3d":
        pairs = [(box_utils.boxes_to_corners_3d(boxes), jax_box_utils.boxes_to_corners_3d(boxes))]
    elif fn in ("mask_center", "mask_corners"):
        kw = dict(use_center_to_filter=fn == "mask_center")
        pairs = [(box_utils.mask_boxes_outside_range_numpy(boxes, rng_lim, **kw),
                  jax_box_utils.mask_boxes_outside_range_numpy(boxes, rng_lim, **kw))]
    elif fn == "camera_to_lidar":
        pairs = [(box_utils.boxes3d_kitti_camera_to_lidar(boxes, calib),
                  jax_box_utils.boxes3d_kitti_camera_to_lidar(boxes, jcalib))]
    elif fn == "lidar_to_camera":
        pairs = [(box_utils.boxes3d_lidar_to_kitti_camera(boxes, calib),
                  jax_box_utils.boxes3d_lidar_to_kitti_camera(boxes, jcalib))]
    elif fn == "corners3d_kitti_camera":
        pairs = [(box_utils.boxes3d_to_corners3d_kitti_camera(boxes, bottom_center=bc),
                  jax_box_utils.boxes3d_to_corners3d_kitti_camera(boxes, bottom_center=bc))
                 for bc in (True, False)]
    elif fn == "camera_to_imageboxes":
        pairs = [(box_utils.boxes3d_kitti_camera_to_imageboxes(boxes, calib, shape),
                  jax_box_utils.boxes3d_kitti_camera_to_imageboxes(boxes, jcalib, shape))
                 for shape in (None, np.array([516, 1936]))]
    else:
        pairs = [(points_in_boxes(pts, boxes), jax_points_in_boxes(pts, boxes))]
        assert pairs[0][1].any()
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_vod_dataset_config_equals_yaml():
    cfg = load_config("configs/hgsfusion_vod.yaml")
    preset = vod_dataset_config(cfg["DATA_CONFIG"]["DATA_PATH"])
    assert preset["CLASS_NAMES"] == cfg["CLASS_NAMES"]
    assert preset["MODEL"]["POST_PROCESSING"] == cfg["MODEL"]["POST_PROCESSING"]
    data = {k: v for k, v in cfg["DATA_CONFIG"].items() if k != "TAG"}
    assert preset["DATA_CONFIG"] == data
    jax_cfg = jax_load_config("configs/hgsfusion_vod.yaml")
    assert {k: v for k, v in jax_cfg.DATA_CONFIG.items() if k != "TAG"} == data


def test_training_and_unported_datasets_raise(tree):
    data_cfg, names = _full_cfg(tree)
    # the database sampler is queue 1 item 9; a disabled one is skipped
    aug = {"DISABLE_AUG_LIST": [],
           "AUG_CONFIG_LIST": [{"NAME": "gt_sampling"}, {"NAME": "random_world_translation"}]}
    with pytest.raises(NotImplementedError, match="gt_sampling is not ported.*item 9"):
        build_dataset({**data_cfg, "DATA_AUGMENTOR": aug}, names, training=True)
    ported = {**aug, "DISABLE_AUG_LIST": ["gt_sampling"]}
    translated = build_dataset({**data_cfg, "DATA_AUGMENTOR": {
        **ported, "AUG_CONFIG_LIST": [{"NAME": "gt_sampling"}, {
            "NAME": "random_world_translation", "NOISE_TRANSLATE_STD": [0.5, 0.5, 0.1]}]}},
        names, training=True)
    assert [c["NAME"] for _, c in translated.data_augmentor.queue] == ["random_world_translation"]
    assert len(build_dataset(data_cfg, names, training=True)) == 3
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        build_dataset({**data_cfg, "DATASET": "KittiDataset"}, names)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        build_dataset({**data_cfg, "DATASET": "NuScenesDataset"}, names)
    with pytest.raises(NotImplementedError, match="gt_sampling"):
        DatasetTemplate({**data_cfg, "DATA_AUGMENTOR": aug}, names, training=True)


def test_jpeg_without_pillow_names_it(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name.split(".")[0] == "PIL":
            raise ImportError("blocked")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="Pillow"):
        image_io.read_image(tmp_path / "x.jpg")
    image_io.write_image(tmp_path / "x.png", np.zeros((2, 3, 3), np.uint8))  # PNG needs no PIL
    assert image_io.read_image(tmp_path / "x.png").shape == (2, 3, 3)
