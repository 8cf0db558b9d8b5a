"""``tools/demo.py`` and its drawing helpers (``utils/visual.py``,
``utils/visual_3d.py``) against the JAX package's, on the CPU: the corner and
projection helpers, the 3-D HTML viewer byte for byte against JAX's
``export_html`` on the same inputs, and the demo CLI's files on a 2-frame
synthetic VoD tree (the radar-only config, and HGSFusion with its camera
image)."""
import numpy as np
import pytest
import yaml

from hgsfusion_tpu.utils import box_utils as jax_box_utils
from hgsfusion_tpu.utils import visual as jax_visual
from hgsfusion_tpu.utils.calibration import Calibration as JaxCalibration
from hgsfusion_tpu.utils.visual_3d import export_html as jax_export_html
from hgsfusion_tpu_torch.config import load_config
from hgsfusion_tpu_torch.datasets.synthetic import make_synthetic_kitti
from hgsfusion_tpu_torch.tools import demo
from hgsfusion_tpu_torch.tools.create_infos import create_infos
from hgsfusion_tpu_torch.utils import visual
from hgsfusion_tpu_torch.utils.calibration import Calibration
from hgsfusion_tpu_torch.utils.visual_3d import export_html
from test_torch_eval import _tiny_cfg
from test_torch_radar_only import _tiny_radar_yaml
from torch_parity import one_torch_thread  # noqa: F401


def _boxes(seed, n=12):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.uniform([2, -10, -2], [40, 10, 1], (n, 3)),
                           rng.uniform(0.5, 5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
                          axis=1).astype(np.float32)


CALIB = {"P2": np.array([[700.0, 0, 480, 45.0], [0, 700, 250, -0.3], [0, 0, 1, 0.005]]),
         "R0": np.eye(3), "Tr_velo2cam": np.array([[0, -1, 0, 0.1], [0, 0, -1, -0.2],
                                                   [1, 0, 0, 0.3]])}


@pytest.mark.parametrize("helper", ["corners_bev", "corners_3d", "lidar_to_img",
                                    "calib_lidar_to_img"])
def test_helpers_match_jax(helper):
    boxes = _boxes(0)
    if helper == "corners_bev":
        got, want = visual.boxes_to_corners_bev(boxes), jax_box_utils.boxes_to_corners_bev(boxes)
    elif helper == "corners_3d":
        got, want = visual.boxes_to_corners_3d(boxes), jax_visual.boxes_to_corners_3d(boxes)
    elif helper == "lidar_to_img":
        l2c = np.vstack([CALIB["Tr_velo2cam"], [0, 0, 0, 1]])
        pts = visual.boxes_to_corners_3d(boxes).reshape(-1, 3)
        got = visual.lidar_to_img(pts, l2c, CALIB["P2"])
        want = jax_visual.lidar_to_img(pts, l2c, CALIB["P2"])
    else:
        pts = visual.boxes_to_corners_3d(boxes).reshape(-1, 3)
        got = np.concatenate([a.reshape(len(pts), -1) for a in
                              Calibration(CALIB).lidar_to_img(pts)], axis=1)
        want = np.concatenate([a.reshape(len(pts), -1) for a in
                               JaxCalibration(CALIB).lidar_to_img(pts)], axis=1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("case", ["full", "no_points", "boxes_only_gt"])
def test_html_equals_jax(tmp_path, case):
    rng = np.random.RandomState(1)
    pts = rng.uniform(-20, 20, (500, 4)).astype(np.float32)
    kw = {"gt_boxes": _boxes(2, 5), "pred_boxes": _boxes(3, 7),
          "pred_scores": rng.rand(7).astype(np.float32), "title": "frame 000 <b>&"}
    if case == "no_points":
        pts = pts[:0]
    if case == "boxes_only_gt":
        kw = {"gt_boxes": kw["gt_boxes"]}
    got = export_html(tmp_path / "port.html", pts, **kw).read_bytes()
    want = jax_export_html(tmp_path / "jax.html", pts, **kw).read_bytes()
    assert got == want and b"<canvas" in got


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A 2-frame tree, its infos, and the cut radar-only and HGSFusion YAMLs."""
    tmp = tmp_path_factory.mktemp("demo")
    root = tmp / "data"
    make_synthetic_kitti(root, num_frames=2, num_points=256, num_virtual=64,
                         image_hw=(64, 96), structured=True)
    radar = _tiny_radar_yaml(root)
    fusion = _tiny_cfg(load_config("configs/hgsfusion_vod.yaml"), root)
    fusion.pop("TAG")
    fusion["MODEL"]["POST_PROCESSING"]["SCORE_THRESH"] = 0.0
    create_infos(radar["DATA_CONFIG"], radar["CLASS_NAMES"])
    paths = {}
    for name, cfg in (("radar", radar), ("fusion", fusion)):
        paths[name] = tmp / f"{name}.yaml"
        paths[name].write_text(yaml.safe_dump(cfg, sort_keys=False))
    return tmp, paths


@pytest.mark.parametrize("name,pngs", [("radar", 1), ("fusion", 2)])
def test_demo_writes_its_files(trees, name, pngs):
    """BEV PNGs, the camera PNG where the frame has an image, the HTML;
    every frame served through the CPU route of the NMS op."""
    tmp, paths = trees
    out = tmp / f"out_{name}"
    result = demo.main(["--cfg_file", str(paths[name]), "--device", "cpu", "--frames", "2",
                        "--out_dir", str(out), "--html"])
    assert result["frames"] == 2 and result["matplotlib"]
    assert len(result["png"]) == 2 * pngs and len(result["html"]) == 2
    for f in result["png"]:
        assert open(f, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    for f in result["html"]:
        assert "pred_boxes" in open(f).read()
    assert sorted(p.name for p in out.iterdir()) == sorted(
        [f"{i:05d}_bev.png" for i in range(2)] + [f"{i:05d}_3d.html" for i in range(2)]
        + ([f"{i:05d}_img.png" for i in range(2)] if pngs == 2 else []))
