"""CenterPoint, SECOND and VoxelNeXt (``models/detector.py``'s
``CenterPointModel``, ``SECONDModel``, ``VoxelNeXtModel``) against the JAX
package's, on the CPU, f32, at the JAX tests' TINY sizes ((0, -8, -3, 16,
8, 2); CenterPoint's classic pillars at 0.5 m, the sparse-pillar archs at
0.25 m, SECOND and VoxelNeXt at 0.5 / 0.125 m: 40 z-planes): every arch in
eval mode, heads within 1e-4; one training step each of CenterPoint
(classic) and SECOND under ``train/step_compare.py`` (BN biases lifted by
4, ``torch_parity.lift_bn_biases``: a plain conv stack in train mode over
a TINY map is ill-conditioned otherwise); SECOND's stride-8 anchor targets
equal to JAX's ``TargetAssigner``'s; the six YAMLs' model configs equal to
JAX's and ``second_focal_vod.yaml`` built and served at TINY; and
``tools/train.py`` -> ``tools/test.py`` -> ``tools/export.py`` ->
``tools/serve.py`` for
``configs/centerpoint_vod.yaml`` cut to TINY on a small synthetic VoD tree.
JAX variables come from ``jax.eval_shape`` and numpy (only the forwards
and the two steps compile)."""

import jax
import numpy as np
import pytest
import torch
import yaml

from hgsfusion_tpu.config import load_config as jax_load_config
from hgsfusion_tpu.config import model_config_from_yaml as jax_model_config
from hgsfusion_tpu.models.anchors import TargetAssigner as JaxAssigner
from hgsfusion_tpu.models.detector import CenterPointModel as JaxCenterPoint
from hgsfusion_tpu.models.detector import HGSFusionConfig as JaxConfig
from hgsfusion_tpu.models.detector import SECONDModel as JaxSECOND
from hgsfusion_tpu.models.detector import VoxelNeXtModel as JaxVoxelNeXt
from hgsfusion_tpu.train.trainer import make_center_train_step as jax_center_step
from hgsfusion_tpu.train.trainer import make_train_step as jax_anchor_step
from hgsfusion_tpu_torch.config import load_config, model_config_from_yaml
from hgsfusion_tpu_torch.datasets import build_dataset
from hgsfusion_tpu_torch.datasets.synthetic import make_synthetic_kitti
from hgsfusion_tpu_torch.models.anchors import TargetAssigner
from hgsfusion_tpu_torch.models.detector import CenterPointModel, SECONDModel, VoxelNeXtModel
from hgsfusion_tpu_torch.models.registry import build_network, yaml_network_class
from hgsfusion_tpu_torch.tools import export, serve, train
from hgsfusion_tpu_torch.tools import test as port_test
from hgsfusion_tpu_torch.tools.create_infos import create_infos
from hgsfusion_tpu_torch.train.trainer import make_train_step_for_cfg
from hgsfusion_tpu_torch.weights import from_jax_variables
from test_train import OPTIM_CFG
from torch_parity import (compare_one_step, lift_bn_biases, load,  # noqa: F401
                          one_torch_thread, port_config, shaped_variables)

HEAD_TOL = 1e-4
BN_LIFT = 4.0
RANGE = (0.0, -8.0, -3.0, 16.0, 8.0, 2.0)
ANCHORS = tuple(
    {"class_name": c, "anchor_sizes": (s,), "anchor_rotations": (0.0, 1.57),
     "anchor_bottom_heights": (h,), "align_center": False, "feature_map_stride": 8,
     "matched_threshold": m, "unmatched_threshold": u}
    for c, s, h, m, u in (("Car", (3.9, 1.6, 1.56), -1.78, 0.6, 0.45),
                          ("Pedestrian", (0.8, 0.6, 1.73), -0.6, 0.5, 0.35),
                          ("Cyclist", (1.76, 0.6, 1.73), -0.6, 0.5, 0.35)))
SECOND_LOSS = {"cls_weight": 1.0, "loc_weight": 2.0, "dir_weight": 0.2,
               "code_weights": (1.0,) * 7}
ARCHS = {  # name -> (JAX model, port model, JAX config)
    "centerpoint": (JaxCenterPoint, CenterPointModel,
                    JaxConfig(pc_range=RANGE, voxel_size=(0.5, 0.5, 0.5), center_max_k=16,
                              num_point_features=5)),
    "centerpoint_res2d": (JaxCenterPoint, CenterPointModel, JaxConfig(
        pc_range=RANGE, voxel_size=(0.25, 0.25, 0.5), center_max_k=16, num_point_features=5,
        center_feature_map_stride=8, backbone_3d_arch="pillar_res2d_8x")),
    "centerpoint_pillar8x": (JaxCenterPoint, CenterPointModel, JaxConfig(
        pc_range=RANGE, voxel_size=(0.25, 0.25, 0.5), center_max_k=16, num_point_features=5,
        center_feature_map_stride=8, backbone_3d_arch="pillar_8x")),
    "second": (JaxSECOND, SECONDModel, JaxConfig(
        pc_range=RANGE, voxel_size=(0.5, 0.5, 0.125), num_anchors_per_location=6,
        num_point_features=5)),
    "voxelnext": (JaxVoxelNeXt, VoxelNeXtModel, JaxConfig(
        pc_range=RANGE, voxel_size=(0.5, 0.5, 0.125), center_max_k=16, num_point_features=5,
        center_feature_map_stride=8)),
    "voxelnext2d": (JaxVoxelNeXt, VoxelNeXtModel, JaxConfig(
        pc_range=RANGE, voxel_size=(0.25, 0.25, 0.5), center_max_k=16, num_point_features=5,
        center_feature_map_stride=8, backbone_3d_arch="voxelnext2d")),
}
YAMLS = {"configs/centerpoint_vod.yaml": CenterPointModel,
         "configs/centerpoint_pillarres2d_vod.yaml": CenterPointModel,
         "configs/second_vod.yaml": SECONDModel, "configs/voxelnext_vod.yaml": VoxelNeXtModel,
         "configs/voxelnext2d_vod.yaml": VoxelNeXtModel,
         "configs/centerpoint_nuscenes.yaml": CenterPointModel}
PORT_ONLY = ("anchor_generator", "loss_weights", "score_thresh", "nms_thresh", "nms_pre_max_size",
             "nms_post_max_size", "nms_type", "optimization")


def _batch(seed=0, n=256):
    """Points over the range, 5 features (x, y, z and two others), several
    to a voxel; two gt boxes."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((1, n, 5), np.float32)
    pts[0, :, 0] = rng.uniform(0.5, 15, n)
    pts[0, :, 1] = rng.uniform(-7, 7, n)
    pts[0, :, 2] = rng.uniform(-2.5, 1.5, n)
    pts[0, :, 3:] = rng.randn(n, 2)
    gt = np.zeros((1, 4, 8), np.float32)
    gt[0, 0] = [4, -2, -0.5, 3.9, 1.6, 1.56, 0.3, 1]
    gt[0, 1] = [10.3, 3.2, -0.8, 0.8, 0.6, 1.73, -1.0, 2]
    return {"points": pts, "points_valid": np.ones((1, n), bool), "gt_boxes": gt}


def _port_cfg(name, **overrides):
    cfg = ARCHS[name][2]
    extra = {"anchor_generator": ANCHORS, "loss_weights": SECOND_LOSS} if name == "second" else {}
    return port_config(cfg, **{**extra, **overrides})


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_matches_jax(name):
    """Every head output within 1e-4 (the dense maps: no ranking in the
    forward pass), the port's keys and shapes JAX's."""
    jax_cls, port_cls, cfg = ARCHS[name]
    model = jax_cls(cfg=cfg)
    batch = _batch()
    variables = shaped_variables(model, batch, False, seed=1)
    ref = jax.jit(lambda v, b: model.apply(v, b, False))(variables, batch)
    port = load(port_cls(_port_cfg(name), device="cpu"), from_jax_variables(variables))
    with torch.no_grad():
        got = port(port.batch_to_device(batch))
    assert set(got) == set(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        assert got[k].shape == r.shape, k
        np.testing.assert_allclose(got[k].numpy(), r, atol=HEAD_TOL, rtol=HEAD_TOL, err_msg=k)
    with torch.no_grad():
        dets = port.post_process(got)
    rows = port.cfg.nms_post_max_size
    assert dets["boxes"].shape == (1, rows, 7) and dets["valid"].shape == (1, rows)


@pytest.mark.parametrize("name", ["centerpoint", "second"])
def test_one_step_matches_jax(name):
    """One step from the same weights: loss terms, gradients, updated
    parameters and BN statistics (``compare_one_step``)."""
    jax_cls, port_cls, cfg = ARCHS[name]
    model = jax_cls(cfg=cfg)
    batch = _batch()
    variables = lift_bn_biases(shaped_variables(model, batch, False, seed=2), BN_LIFT)
    pcfg = _port_cfg(name) if name == "second" else _port_cfg(name, loss_weights={})
    if name == "second":
        assigner = JaxAssigner([dict(c) for c in ANCHORS], cfg.grid_size, cfg.pc_range,
                               class_names=cfg.class_names)

        def jax_make(tx):
            return jax_anchor_step(model, assigner, tx, dict(SECOND_LOSS), cfg,
                                   use_occ_loss=False)
    else:
        def jax_make(tx):
            return jax_center_step(model, tx, {}, cfg)

    def port_step(m, opt):
        assert isinstance(m, port_cls)
        return make_train_step_for_cfg(m, opt, pcfg)[1]

    report = compare_one_step(variables, jax_make, lambda: port_cls(pcfg, device="cpu"),
                              port_step, batch, OPTIM_CFG)
    print(report)


def test_second_stride8_targets_match_jax():
    """The assigner over SECOND's stride-8 anchors (4 x 4 x 6 at TINY):
    labels equal JAX's, targets within 1e-5."""
    cfg = ARCHS["second"][2]
    gt = _batch()["gt_boxes"]
    assigner = JaxAssigner([dict(c) for c in ANCHORS], cfg.grid_size, cfg.pc_range,
                           class_names=cfg.class_names)
    ref = jax.jit(assigner)(gt)
    got = TargetAssigner(ANCHORS, cfg.grid_size, cfg.pc_range, cfg.class_names,
                         device="cpu")(torch.from_numpy(gt))
    assert got["box_cls_labels"].shape == (1, 96) and int((got["box_cls_labels"] > 0).sum()) > 0
    np.testing.assert_array_equal(got["box_cls_labels"].numpy(),
                                  np.asarray(ref["box_cls_labels"]))
    np.testing.assert_allclose(got["box_reg_targets"].numpy(), np.asarray(ref["box_reg_targets"]),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("path", sorted(YAMLS))
def test_yaml_config_and_family(path):
    """Each YAML's family, and its model config equal to the JAX package's
    on every field they share (the head layout, backbone_3d_arch and
    BaseBEVBackboneV1's fields among them)."""
    cfg = load_config(path)
    assert yaml_network_class(cfg) is YAMLS[path]
    ref = jax_model_config(jax_load_config(path))
    got = model_config_from_yaml(cfg)
    assert got == port_config(ref, **{f: getattr(got, f) for f in PORT_ONLY})
    assert got.nms_type == "nms_gpu"
    if "nuscenes" in path:
        assert got.center_head_channels == (2, 1, 3, 2, 2) and got.nms_post_max_size == 83


def test_focal_second_builds_and_serves():
    """``second_focal_vod.yaml`` builds the SECOND on VoxelBackBone8xFocal;
    cut to the TINY range (41 planes) it serves a frame."""
    cfg = load_config("configs/second_focal_vod.yaml")
    assert model_config_from_yaml(cfg).backbone_3d_arch == "voxel8x_focal"
    cfg["DATA_CONFIG"]["POINT_CLOUD_RANGE"] = list(RANGE)
    cfg["DATA_CONFIG"]["DATA_PROCESSOR"][1]["VOXEL_SIZE"] = [0.5, 0.5, 0.125]
    model = build_network(cfg, device="cpu")
    assert isinstance(model, SECONDModel) and hasattr(model.backbone_3d, "focal3")
    batch = _batch()
    dets = model.serve({**batch, "points": np.concatenate(
        [batch["points"], np.zeros((1, 256, 12), np.float32)], axis=-1)})
    assert dets["boxes"].shape == (1, 500, 7) and bool(torch.isfinite(dets["boxes"]).all())


def _tiny_centerpoint_yaml(root):
    """configs/centerpoint_vod.yaml cut to the TINY range (32 x 32 pillars at
    0.5 m, the head at 16 x 16), 16 candidates, every candidate inside the
    center limits a detection (random weights leave every score near
    sigmoid(-2.19))."""
    cfg = load_config("configs/centerpoint_vod.yaml")
    cfg.pop("TAG")
    data = cfg["DATA_CONFIG"]
    data.update(DATA_PATH=str(root), POINT_CLOUD_RANGE=list(RANGE), MAX_POINTS=512,
                MAX_GT_BOXES=16, VIRTUAL_POINT_PREFIX="virtual_points")
    data["DATA_PROCESSOR"][1]["VOXEL_SIZE"] = [0.5, 0.5, 0.5]
    post = cfg["MODEL"]["POST_PROCESSING"]
    post.update(MAX_OBJ_PER_SAMPLE=16, SCORE_THRESH=-1.0)
    post["NMS_CONFIG"].update(NMS_POST_MAXSIZE=16)
    return cfg


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """Two training steps on a 4-frame tree, ``tools/test.py --ckpt_dir``
    over 2 frames, an export of the checkpoint served by ``tools/serve.py``
    on one frame."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("centerpoint_cli")
    root = tmp / "data"
    make_synthetic_kitti(root, num_frames=4, num_points=256, num_virtual=64, image_hw=(64, 96),
                         structured=True)
    cfg = _tiny_centerpoint_yaml(root)
    create_infos(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"])
    path = tmp / "centerpoint.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    out = tmp / "out"
    trained = train.main(["--cfg_file", str(path), "--device", "cpu", "--workers", "0",
                          "--epochs", "1", "--max_steps", "2", "--output_dir", str(out)])
    ckpt = out / "centerpoint" / "default" / "ckpt"
    tested = port_test.main(["--cfg_file", str(path), "--device", "cpu", "--ckpt_dir", str(ckpt),
                             "--max_frames", "2", "--output_dir", str(out)])
    artifact = tmp / "centerpoint.pt2"
    exported = export.main(["--cfg_file", str(path), "--device", "cpu", "--ckpt_dir", str(ckpt),
                            "--out", str(artifact)])
    ds = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False)
    frame = ds.collate_batch([ds[0]])
    np.savez(tmp / "f0.npz", **{k: np.asarray(frame[k]) for k in exported["inputs"]})
    served = serve.main(["--artifact", str(artifact), "--inputs", str(tmp / "f0.npz"),
                         "--out_dir", str(tmp / "dets"), "--warmup", "0"])
    model = build_network(load_config(path), device="cpu")
    model.load_state_dict(torch.load(ckpt / "checkpoint_step_2.pth", map_location="cpu",
                                     weights_only=True)["model_state"])
    direct = {k: v.numpy() for k, v in model.serve(frame).items()}
    return {"train": trained, "test": tested, "export": exported, "served": served,
            "dets": dict(np.load(tmp / "dets" / "f0_dets.npz")), "direct": direct}


def test_cli_trains_tests_exports_and_serves(cli_run):
    trained, tested = cli_run["train"], cli_run["test"]
    assert trained["steps"] == 2 and all(np.isfinite(trained["losses"]))
    assert [s["step"] for s in trained["saves"]] == [2]
    result, stats = tested[2]
    assert stats["frames"] == 2 and all(0 <= v <= 100 for v in result.values())
    assert {"points", "points_valid"} <= set(cli_run["export"]["inputs"])
    assert "images" not in cli_run["export"]["inputs"]
    assert cli_run["dets"]["boxes"].shape == (1, 16, 7)
    for k, v in cli_run["dets"].items():
        np.testing.assert_array_equal(v, cli_run["direct"][k], err_msg=k)
    assert cli_run["direct"]["valid"].any()
