"""BEVFusion and TransFusion-L (``models/detector.py``'s ``BEVFusionModel``
and ``TransFusionModel``) against the JAX package's, on the CPU, f32, at
``tests/test_bevfusion.py``'s TINY size (a 32 x 32 x 40 voxel grid at 0.5 /
0.125 m, a 64 x 96 image, 16 depth bins, 16 proposals; the Swin of two
stages of two 16- and 32-wide blocks): both camera branches and
TransFusion-L in eval mode within 1e-4, one BEVFusion training step under
``train/step_compare.py``, DropPath at rate 0 equal to JAX's and at rate p
keeping a 1 - p share within 5 binomial standard deviations, each YAML's
model config equal to JAX's, and ``tools/train.py`` -> ``tools/test.py`` ->
``tools/export.py`` -> ``tools/serve.py`` and ``tools/demo.py`` on a small
synthetic VoD tree.
JAX variables come from ``jax.eval_shape`` and numpy (only the forwards and
the step compile)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import yaml

from hgsfusion_tpu.config import load_config as jax_load_config
from hgsfusion_tpu.config import model_config_from_yaml as jax_model_config
from hgsfusion_tpu.models import swin as jswin
from hgsfusion_tpu.models.detector import BEVFusionModel as JaxBEVFusion
from hgsfusion_tpu.models.detector import HGSFusionConfig as JaxConfig
from hgsfusion_tpu.models.detector import TransFusionModel as JaxTransFusion
from hgsfusion_tpu.train.trainer import make_transfusion_train_step as jax_make_step
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.config import load_config, model_config_from_yaml
from hgsfusion_tpu_torch.datasets import build_dataset
from hgsfusion_tpu_torch.datasets.synthetic import make_synthetic_kitti
from hgsfusion_tpu_torch.models import swin
from hgsfusion_tpu_torch.models.detector import BEVFusionModel, TransFusionModel
from hgsfusion_tpu_torch.models.registry import build_network, yaml_network_class
from hgsfusion_tpu_torch.tools import demo, export, serve, train
from hgsfusion_tpu_torch.tools import test as port_test
from hgsfusion_tpu_torch.tools.create_infos import create_infos
from hgsfusion_tpu_torch.train.trainer import make_train_step_for_cfg
from hgsfusion_tpu_torch.weights import from_jax_variables
from test_bevfusion import _batch
from test_train import OPTIM_CFG
from torch_parity import (compare_one_step, lift_bn_biases, load,  # noqa: F401
                          one_torch_thread, port_config, shaped_variables, t)

HEAD_TOL = 1e-4
BN_LIFT = 4.0  # torch_parity.lift_bn_biases, for the step test
TINY = JaxConfig(pc_range=(0.0, -8.0, -3.0, 16.0, 8.0, 2.0), voxel_size=(0.5, 0.5, 0.125),
                 image_size=(64, 96), disc_num_bins=16, disc_depth_max=16.0, center_max_k=16,
                 center_feature_map_stride=8, num_point_features=4)
SWIN = dict(image_backbone_arch="swin", swin_embed_dims=16, swin_depths=(2, 2),
            swin_num_heads=(2, 4), swin_window_size=4, swin_mlp_ratio=2, swin_out_indices=(0, 1),
            fpn_out_channels=24)
TINY_SWIN = dataclasses.replace(TINY, **SWIN)
TINY_TF = dataclasses.replace(TINY, voxel_size=(0.5, 0.5, 0.5), center_feature_map_stride=2,
                              num_point_features=5)
YAMLS = {"configs/bevfusion_vod.yaml": BEVFusionModel,
         "configs/transfusion_vod.yaml": TransFusionModel}


def _tf_batch(seed=0):
    rng = np.random.RandomState(seed)
    pts = np.zeros((1, 128, 5), np.float32)
    pts[0, :, 0] = rng.uniform(0.5, 15, 128)
    pts[0, :, 1] = rng.uniform(-7, 7, 128)
    pts[0, :, 2] = rng.uniform(-2, 1, 128)
    pts[0, :, 3:] = rng.randn(128, 2)
    gt = np.zeros((1, 4, 8), np.float32)
    gt[0, 0] = [4, -2, -0.5, 3.9, 1.6, 1.56, 0.3, 1]
    return {"points": pts, "points_valid": np.ones((1, 128), bool), "gt_boxes": gt}


def _forward_pair(jax_model, port_cls, cfg, batch, seed: int):
    variables = shaped_variables(jax_model, batch, False, seed=seed)
    ref = jax.jit(lambda v, b: jax_model.apply(v, b, False))(variables, batch)
    model = load(port_cls(port_config(cfg), device="cpu"), from_jax_variables(variables))
    with torch.no_grad():
        got = model(model.batch_to_device(batch))
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("family", ["bevfusion_swin", "bevfusion_ddn", "transfusion"])
def test_forward_matches_jax(family):
    """Every head output within 1e-4 (the proposals' order included: these
    inputs leave no two peak scores within 1e-5 of each other)."""
    if family == "transfusion":
        ref, got = _forward_pair(JaxTransFusion(cfg=TINY_TF), TransFusionModel, TINY_TF,
                                 _tf_batch(), seed=2)
    else:
        cfg = TINY_SWIN if family == "bevfusion_swin" else TINY
        batch = {k: np.asarray(v) for k, v in _batch(np.random.RandomState(0)).items()}
        ref, got = _forward_pair(JaxBEVFusion(cfg=cfg), BEVFusionModel, cfg, batch, seed=1)
    assert set(got) == set(ref) and ref["heatmap"].shape == (1, 16, 3)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], atol=HEAD_TOL, rtol=HEAD_TOL, err_msg=k)


def test_one_step_matches_jax():
    """One BEVFusion (swin) step: the Hungarian-matched loss terms,
    gradients, updated parameters and BN statistics. Stochastic depth off
    (rate 0): the JAX step draws no ``droppath`` key. Every BN bias lifted
    by BN_LIFT: the TINY BEV maps are 4 x 4 and 2 x 2, so a train-mode BN
    takes its statistics over 16 or 4 values, and without the lift the two
    frameworks' f32 variances (E[x^2] - E[x]^2, summed in another order)
    move the step's outputs by 1e-4 to 1e-3 at every weight seed tried."""
    cfg = dataclasses.replace(TINY_SWIN, swin_drop_path=0.0)
    model = JaxBEVFusion(cfg=cfg)
    batch = {k: np.asarray(v) for k, v in _batch(np.random.RandomState(0)).items()}
    variables = lift_bn_biases(shaped_variables(model, batch, False, seed=4), BN_LIFT)
    pcfg = port_config(cfg, loss_weights={})

    def port_step(m, opt):
        assert isinstance(m, BEVFusionModel)
        return make_train_step_for_cfg(m, opt, pcfg)[1]

    report = compare_one_step(variables, lambda tx: jax_make_step(model, tx, {}, cfg),
                              lambda: BEVFusionModel(pcfg, device="cpu"), port_step, batch,
                              OPTIM_CFG)
    print(report)


def test_drop_path_matches_jax_at_rate_0_and_keeps_1_minus_p():
    images = np.random.RandomState(3).rand(2, 20, 28, 3).astype(np.float32)
    module = jswin.SwinTransformer(embed_dims=16, depths=(2, 2), num_heads=(2, 4), window_size=4,
                                   mlp_ratio=2, out_indices=(0, 1), drop_path_rate=0.0)
    variables = shaped_variables(module, images, False, seed=5)
    ref = jax.jit(lambda v, x: module.apply(v, x, True))(variables, images)
    port = swin.SwinTransformer(16, (2, 2), (2, 4), 4, 2, (0, 1))
    port.load_state_dict(weights.swin_transformer(variables["params"]), strict=True)
    got = port.train()(t(images))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), atol=1e-5)

    p, n = 0.3, 20000
    drop = swin.DropPath(p).train()
    x = torch.ones(n, 4, 3)
    y = drop(x, torch.Generator().manual_seed(0))
    kept = (y[:, 0, 0] != 0).float()
    bound = 5 * np.sqrt(p * (1 - p) / n)
    assert abs(float(kept.mean()) - (1 - p)) < bound
    assert torch.equal(y[kept.bool()], torch.full_like(y[kept.bool()], 1 / (1 - p)))
    assert torch.equal(y, drop(x, torch.Generator().manual_seed(0)))  # the generator decides
    assert torch.equal(drop.eval()(x), x)
    with pytest.raises(ValueError, match="generator"):
        drop.train()(x)


@pytest.mark.parametrize("path", sorted(YAMLS))
def test_yaml_config_and_family(path):
    """Each YAML's family, and its model config equal to the JAX package's
    on every field they share (MAX_OBJ_PER_SAMPLE 200, both strides, the
    Swin and FPN of BEVFusion's)."""
    cfg = load_config(path)
    assert yaml_network_class(cfg) is YAMLS[path]
    ref = jax_model_config(jax_load_config(path))
    got = model_config_from_yaml(cfg)
    assert got == port_config(ref, **{f: getattr(got, f) for f in (
        "anchor_generator", "loss_weights", "score_thresh", "nms_thresh", "nms_pre_max_size",
        "nms_post_max_size", "optimization")})
    assert got.center_max_k == 200 and got.anchor_generator == ()
    assert got.image_backbone_arch == ("swin" if "bevfusion" in path else "ddn")


def _tiny_bevfusion_yaml(root):
    """configs/bevfusion_vod.yaml cut to TINY_SWIN over a 64 x 96 tree."""
    cfg = load_config("configs/bevfusion_vod.yaml")
    cfg.pop("TAG")
    data = cfg["DATA_CONFIG"]
    data.update(DATA_PATH=str(root), POINT_CLOUD_RANGE=[0, -8, -3, 16, 8, 2], IMAGE_SIZE=[64, 96],
                MAX_POINTS=512, MAX_GT_BOXES=16, VIRTUAL_POINT_PREFIX="virtual_points")
    data["DATA_PROCESSOR"][1]["VOXEL_SIZE"] = [0.5, 0.5, 0.125]
    model = cfg["MODEL"]
    model["IMAGE_BACKBONE"].update(EMBED_DIMS=16, DEPTHS=[2, 2], NUM_HEADS=[2, 4], WINDOW_SIZE=4,
                                   MLP_RATIO=2, OUT_INDICES=[0, 1])
    model["NECK"]["OUT_CHANNELS"] = 24
    model["FusionVFE"]["ImageVFE"]["FFN"]["DISCRETIZE"].update(num_bins=16, depth_max=16.0)
    # every proposal inside the center limits is a detection (random weights
    # leave most peak scores at 0)
    model["POST_PROCESSING"].update(MAX_OBJ_PER_SAMPLE=16, SCORE_THRESH=-1.0)
    return cfg


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """Two training steps on a 4-frame tree, ``tools/test.py --ckpt_dir``
    over 2 frames, an export of the checkpoint served by ``tools/serve.py``
    on one frame, ``tools/demo.py`` on one frame."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("bevfusion_cli")
    root = tmp / "data"
    make_synthetic_kitti(root, num_frames=4, num_points=256, num_virtual=64, image_hw=(64, 96),
                         structured=True)
    cfg = _tiny_bevfusion_yaml(root)
    create_infos(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"])
    path = tmp / "bevfusion.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    out = tmp / "out"
    trained = train.main(["--cfg_file", str(path), "--device", "cpu", "--workers", "0",
                          "--epochs", "1", "--max_steps", "2", "--output_dir", str(out)])
    ckpt = out / "bevfusion" / "default" / "ckpt"
    tested = port_test.main(["--cfg_file", str(path), "--device", "cpu", "--ckpt_dir", str(ckpt),
                             "--max_frames", "2", "--output_dir", str(out)])
    artifact = tmp / "bevfusion.pt2"
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
    shown = demo.main(["--cfg_file", str(path), "--device", "cpu", "--ckpt_dir", str(ckpt),
                       "--frames", "1", "--html", "--out_dir", str(tmp / "demo")])
    return {"train": trained, "test": tested, "export": exported, "served": served,
            "dets": dict(np.load(tmp / "dets" / "f0_dets.npz")), "direct": direct,
            "demo": shown}


def test_cli_trains_tests_exports_and_serves(cli_run):
    trained, tested = cli_run["train"], cli_run["test"]
    assert trained["steps"] == 2 and all(np.isfinite(trained["losses"]))
    assert [s["step"] for s in trained["saves"]] == [2]
    result, stats = tested[2]
    assert stats["frames"] == 2
    assert {"images", "points", "trans_cam_to_img"} <= set(cli_run["export"]["inputs"])
    assert cli_run["dets"]["boxes"].shape == (1, 16, 7)
    for k, v in cli_run["dets"].items():
        np.testing.assert_array_equal(v, cli_run["direct"][k], err_msg=k)
    assert cli_run["direct"]["valid"].any()
    assert cli_run["demo"]["frames"] == 1 and len(cli_run["demo"]["html"]) == 1
