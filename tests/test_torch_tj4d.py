"""TJ4DRadSet through the port against the JAX package, on the CPU.

The data half: a synthetic TJ4D-format tree (``make_synthetic_tj4d``: 8
radar channels, PNG images, six-digit frame ids in the weather groups, boxes
from 10 m to past 70 m) read by both packages' ``TJ4DDataset`` under
``configs/hgsfusion_tj4d.yaml``'s data config: infos, frames and batches
bit for bit, training frames bit for bit at TJ4D's augmentation ranges
under one ``np.random`` seed, and the official evaluation (range
difficulties, the four classes in their forced order, two IoU tiers, the
41-sample AP40, the weather groups) equal.

The model half: ``hgsfusion_tj4d_pallas.yaml`` cut to a TINY model
(``chip_smoke.tiny_tj4d_cut``) that keeps what TJ4D changes (4 classes, 8
anchors in the order Car, Truck, Ped, Cyc, 18 point features split into the
31-wide reader, ASPP dilation 3, no BEV_AUG) on a non-square grid (32 x 40 x
6 voxels) and a 50 x 80 image (ragged backbone maps), ResNet-50, f32, over a
tree whose boxes lie in its range.
JAX weights (BN statistics perturbed) are carried across by
``weights.from_jax_variables``. Serving is held to 1e-4; one training step
at B=2 (two augmented frames, the frozen backbone's residual scales at 0)
to ``train/step_compare.py``'s bounds; ``run_eval`` over the tree to boxes
within 1e-4 and a result dict within 1e-6 at a tie-free score threshold.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import tie_free_threshold, tiny_tj4d_cut, write_tiny_tj4d_tree
from hgsfusion_tpu.config import ConfigDict
from hgsfusion_tpu.config import load_config as jax_load_config
from hgsfusion_tpu.config import model_config_from_yaml as jax_model_config
from hgsfusion_tpu.datasets import build_dataset as jax_build_dataset
from hgsfusion_tpu.eval.tj4d_eval import tj4d_official_eval as jax_tj4d_official_eval
from hgsfusion_tpu.models.anchors import TargetAssigner as JaxAssigner
from hgsfusion_tpu.models.registry import build_network
from hgsfusion_tpu.train.optim import build_optimizer as jax_build_optimizer
from hgsfusion_tpu.train.trainer import TrainState, add_init_anchors, device_batch
from hgsfusion_tpu.train.trainer import make_train_step as jax_make_train_step
from hgsfusion_tpu.utils.common import create_logger as jax_create_logger
from hgsfusion_tpu_torch.config import load_config, model_config_from_yaml
from hgsfusion_tpu_torch.datasets import build_dataset
from hgsfusion_tpu_torch.datasets.synthetic import make_synthetic_tj4d
from hgsfusion_tpu_torch.eval.kitti_ap import get_map_r40
from hgsfusion_tpu_torch.eval.tj4d_eval import EVAL_ORDER, tj4d_official_eval
from hgsfusion_tpu_torch.models.anchors import TargetAssigner
from hgsfusion_tpu_torch.models.detector import HGSFusionModel
from hgsfusion_tpu_torch.tools import test as port_test
from hgsfusion_tpu_torch.tools.create_infos import create_infos
from hgsfusion_tpu_torch.train.optim import build_optimizer
from hgsfusion_tpu_torch.train.step_compare import (GradCapture, compare_steps, perturb_inputs,
                                                    sensitivity, step_record)
from hgsfusion_tpu_torch.train.trainer import make_train_step
from hgsfusion_tpu_torch.utils.common import create_logger
from hgsfusion_tpu_torch.weights import from_jax_variables
from test_torch_data import _assert_tree_equal
from test_torch_eval import _assert_annos_close, _jax_tools_test
from test_torch_train import _capture, _jax_record, _zero_residual_scales
from torch_parity import assert_close, load, one_torch_thread, perturb_variables  # noqa: F401

YAMLS = {"xla": "configs/hgsfusion_tj4d.yaml", "pallas": "configs/hgsfusion_tj4d_pallas.yaml",
         "polar": "configs/hgsfusion_tj4d_polar.yaml"}
CLASSES = ["Car", "Pedestrian", "Cyclist", "Truck"]
HEAD_TOL = 1e-4  # as tests/test_torch_detector.py
BOX_TOL, RESULT_TOL = 1e-4, 1e-6  # as tests/test_torch_eval.py
# no two passing scores of a frame, and no score and the threshold, within
# SCORE_GAP (as tests/test_torch_eval.py)
SCORE_GAP = 1e-7
TOTAL_STEPS = 20
TRAIN_SEED = 5


def _data_cfg(root, **overrides):
    cfg = load_config(YAMLS["xla"])
    data = cfg["DATA_CONFIG"]
    data.update(DATA_PATH=str(root), VIRTUAL_POINT_PREFIX="virtual_points", **overrides)
    return data


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Eight frames at 50x80 with TJ4D's data config (image padded to
    810x1280), infos written by the port."""
    root = tmp_path_factory.mktemp("tj4d") / "data"
    make_synthetic_tj4d(root, num_frames=8, num_points=256, num_virtual=64, image_hw=(50, 80))
    create_infos(_data_cfg(root), CLASSES)
    return root


def test_infos_match_jax(tree, tmp_path):
    jax_ds = jax_build_dataset(ConfigDict(_data_cfg(tree)), CLASSES, training=False)
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
    # the tree's spread: every weather group, a sequence in none, every
    # range difficulty and class
    ids = [i["image"]["image_idx"] for i in got]
    assert len(ids[0]) == 6 and {i[:2] for i in ids} >= {"00", "05", "30", "77"}
    ranges = np.concatenate([np.linalg.norm(i["annos"]["location"], axis=1) for i in got])
    assert ranges.min() < 50 < 70 < ranges.max() and ((ranges > 50) & (ranges <= 70)).any()
    assert set(np.concatenate([i["annos"]["name"] for i in got])) == set(CLASSES)
    assert got[0]["point_cloud"]["num_features"] == 8


def test_frames_and_batches_match_jax(tree):
    data = _data_cfg(tree)
    port = build_dataset(data, CLASSES, training=False)
    ref = jax_build_dataset(ConfigDict(data), CLASSES, training=False)
    assert type(port).__name__ == "TJ4DDataset" and len(port) == len(ref) == 8
    frames = [port[i] for i in range(3)]
    for i, f in enumerate(frames):
        _assert_tree_equal(f, ref[i], f"frame {i}")
    assert frames[0]["points"].shape[1] == 18 and frames[0]["images"].shape == (810, 1280, 3)
    assert (frames[0]["gt_boxes"][:, -1] > 0).sum() >= 4  # boxes beyond 69.12 m dropped
    _assert_tree_equal(port.collate_batch(frames), ref.collate_batch([ref[i] for i in range(3)]),
                       "batch")


@pytest.mark.parametrize("seed", [0, 5])
def test_training_frames_match_jax(tree, seed):
    """TJ4D's augmentation: world flip along x, image flip, rotation within
    +-pi/4 and scaling within [0.95, 1.05], the draws in JAX's order."""
    data = _data_cfg(tree)
    port = build_dataset(data, CLASSES, training=True)
    ref = jax_build_dataset(ConfigDict(data), CLASSES, training=True)
    names = [a["NAME"] for a in data["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"]]
    assert names == ["random_world_flip", "random_image_flip_fusion", "random_world_rotation",
                     "random_world_scaling"]
    np.random.seed(seed)
    got = [port[i] for i in range(8)]
    np.random.seed(seed)
    want = [ref[i] for i in range(8)]
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_tree_equal(g, w, f"frame {i}")
    _assert_tree_equal(port.collate_batch(got[:2]), ref.collate_batch(want[:2]), "batch")
    rots = [g["noise_rot"] for g in got]
    assert all(abs(r) <= np.pi / 4 for r in rots) and max(np.abs(rots)) > 0.3926
    assert all(0.95 <= g["noise_scale"] <= 1.05 for g in got)


def _random_tj4d_frame(rng, n, det):
    """Boxes of the four classes (and a DontCare in the gt) from 3 to 90 m."""
    names = np.array(CLASSES + ["DontCare"])
    dist = rng.uniform(3, 90, n)
    loc = np.stack([rng.uniform(-0.3, 0.3, n) * dist, rng.uniform(0.5, 2.0, n), dist], 1)
    dims = np.stack([rng.uniform(0.5, 11, n), rng.uniform(1.2, 3.5, n),
                     rng.uniform(0.5, 2.7, n)], 1)
    x1, y1 = rng.uniform(0, 1200, n), rng.uniform(0, 750, n)
    anno = {"name": names[rng.randint(0, 4 if det else 5, n)],
            "truncated": rng.uniform(0, 0.5, n), "occluded": rng.randint(0, 3, n).astype(float),
            "alpha": rng.uniform(-np.pi, np.pi, n),
            "bbox": np.stack([x1, y1, x1 + rng.uniform(5, 200, n), y1 + rng.uniform(5, 120, n)], 1),
            "dimensions": dims, "location": loc, "rotation_y": rng.uniform(-np.pi, np.pi, n)}
    if det:
        anno["score"] = rng.uniform(0.05, 1.0, n)
    else:
        anno["difficulty"] = rng.randint(-1, 3, n)
    return anno


def _detections(rng, gt):
    keep = gt["name"] != "DontCare"
    n = int(keep.sum())
    det = {k: np.array(v)[keep] for k, v in gt.items() if k != "difficulty"}
    det["location"] = det["location"] + rng.normal(0, 0.2, (n, 3))
    det["bbox"] = det["bbox"] + rng.normal(0, 4, (n, 4))
    det["score"] = rng.uniform(0.05, 1.0, n)
    extra = _random_tj4d_frame(rng, rng.randint(0, 4), det=True)
    return {k: np.concatenate([det[k], extra[k]]) for k in det}


@pytest.mark.parametrize("weather", [False, True])
def test_official_eval_equals_jax(tree, weather):
    """``TJ4DDataset.evaluation`` over the tree's eight frames (with and
    without FILTER_BY_WEATHER) on random annotations in place of the infos,
    and ``tj4d_official_eval`` alone, against the JAX package's."""
    rng = np.random.RandomState(3)
    data = _data_cfg(tree, FILTER_BY_WEATHER=weather)
    port = build_dataset(data, CLASSES, training=False)
    ref = jax_build_dataset(ConfigDict(data), CLASSES, training=False)
    gts = [_random_tj4d_frame(rng, 0 if f == 2 else rng.randint(1, 9), det=False)
           for f in range(8)]
    for ds in (port, ref):
        for info, gt in zip(ds.infos, gts):
            info["annos"] = gt
    dts = [_detections(rng, g) for g in gts]
    got_str, got = port.evaluation(dts, CLASSES)
    want_str, want = ref.evaluation(dts, CLASSES)
    assert got == want and got_str == want_str
    groups = {k.split("/")[0] for k in got if not k.startswith("KITTI")}
    assert groups == ({"dark", "standard", "shiny", "all_weather"} if weather else set())
    assert max(got.values()) > 0 and "KITTI/Truck_3D_hard_strict" in got
    assert tj4d_official_eval(gts, dts) == jax_tj4d_official_eval(gts, dts)


def test_ap40_sums_all_41_samples():
    """TJ4D's AP40 counts the recall-0 sample that the KITTI R40 skips: one
    Car gt found by one detection gives a precision curve with only that
    sample, 1 / 40 x 100 = 2.5 at the strict tier, where ``get_map_r40``
    gives 0."""
    gt = {"name": np.array(["Car"]), "truncated": np.zeros(1), "occluded": np.zeros(1),
          "alpha": np.zeros(1), "bbox": np.array([[10.0, 10, 60, 50]]),
          "dimensions": np.array([[4.0, 1.5, 1.8]]), "location": np.array([[1.0, 1.5, 20.0]]),
          "rotation_y": np.zeros(1)}
    det = {**gt, "score": np.array([0.9])}
    _, res = tj4d_official_eval([gt], [det])
    assert res["KITTI/Car_3D_easy_strict"] == 2.5
    curve = np.zeros(41)
    curve[0] = 1.0
    assert get_map_r40(curve) == 0.0
    assert EVAL_ORDER == ["Pedestrian", "Cyclist", "Car", "Truck"]


@pytest.mark.parametrize("view", list(YAMLS))
def test_yaml_configs(view):
    """The three TJ4D configs read alike by both packages: TJ4D's grid,
    image, anchors and reader, and each one's view and sampler."""
    pcfg = model_config_from_yaml(load_config(YAMLS[view]))
    jcfg = jax_model_config(jax_load_config(YAMLS[view]))
    for f in ("class_names", "pc_range", "voxel_size", "image_size", "num_point_features",
              "reader_num_input", "aspp_dilation", "bev_aug", "disc_depth_max",
              "num_anchors_per_location", "f2v_view", "f2v_sampler_kernel",
              "f2v_polar_zeta_bins", "f2v_polar_near_columns", "compute_dtype"):
        assert getattr(pcfg, f) == getattr(jcfg, f), f
    assert pcfg.grid_size == jcfg.grid_size == (216, 248, 19)
    assert (pcfg.num_point_features, pcfg.reader_num_input, pcfg.num_anchors_per_location) == (
        18, 31, 8)
    assert (pcfg.aspp_dilation, pcfg.bev_aug, pcfg.image_size) == (3, False, (810, 1280))
    assert [a["class_name"] for a in pcfg.anchor_generator] == ["Car", "Truck", "Pedestrian",
                                                               "Cyclist"]
    assert pcfg.optimization["BATCH_SIZE_PER_DEVICE"] == 2
    assert (pcfg.f2v_view, pcfg.f2v_sampler_kernel) == {
        "xla": ("gather", "xla"), "pallas": ("gather", "pallas"), "polar": ("polar", "xla")}[view]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Both configs (``chip_smoke.tiny_tj4d_cut`` of
    hgsfusion_tj4d_pallas.yaml) and datasets over a 4-frame tree whose boxes
    (Car, Ped, Cyc, Truck from 3 m to about 28 m) lie in its range, one set
    of JAX variables, and the port model carrying them."""
    root = tmp_path_factory.mktemp("tiny_tj4d") / "data"
    write_tiny_tj4d_tree(root)
    pcfg = tiny_tj4d_cut(load_config(YAMLS["pallas"]), root)
    jcfg = ConfigDict(tiny_tj4d_cut(jax_load_config(YAMLS["pallas"]), root))
    create_infos(pcfg["DATA_CONFIG"], pcfg["CLASS_NAMES"])
    logger = create_logger()
    pds = build_dataset(pcfg["DATA_CONFIG"], CLASSES, training=False, logger=logger)
    jds = jax_build_dataset(jcfg.DATA_CONFIG, CLASSES, training=False, logger=jax_create_logger())
    jm = jax_model_config(jcfg)
    m = model_config_from_yaml(pcfg)
    assert m.grid_size == jm.grid_size == (32, 40, 6) and m.num_anchors_per_location == 8
    jmodel = build_network(jcfg, jm)
    init_batch = add_init_anchors(
        {k: jnp.asarray(v) for k, v in device_batch(jds.collate_batch([jds[0]])).items()},
        jcfg, jm)
    variables = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, False))(init_batch)
    variables = perturb_variables(variables, seed=1)
    model = load(HGSFusionModel(m, device="cpu"), from_jax_variables(variables))
    return {"pcfg": pcfg, "jcfg": jcfg, "pds": pds, "jds": jds, "jm": jm, "jmodel": jmodel,
            "variables": variables, "model": model, "logger": logger}


def test_tiny_serve_matches_jax(tiny):
    """Two frames, one of them with a Truck, through both models: every head
    output within 1e-4, the anchors in the JAX layout."""
    t = tiny
    batch = t["pds"].collate_batch([t["pds"][i] for i in range(2)])
    assert (batch["gt_boxes"][..., -1] == 4).any()  # a Truck in the batch
    jb = device_batch(batch)
    ref, _ = jax.jit(lambda v, b: t["jmodel"].apply(v, b, False, mutable=["batch_stats"]))(
        t["variables"], jb)
    with torch.no_grad():
        got = t["model"](t["model"].batch_to_device(batch))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert_close(got[k], np.asarray(ref[k]), atol=HEAD_TOL, rtol=HEAD_TOL, err_msg=k)
    anchors = JaxAssigner([dict(c) for c in t["jcfg"].MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG],
                          t["jm"].grid_size, t["jm"].pc_range,
                          class_names=t["jm"].class_names).flat_anchors
    np.testing.assert_array_equal(t["model"].anchors.numpy(), np.asarray(anchors))


def _port_step(pcfg, variables, batch, perturb_seed=None):
    model = load(HGSFusionModel(pcfg, device="cpu"), from_jax_variables(variables))
    opt, lr_schedule = build_optimizer(pcfg.optimization, TOTAL_STEPS, model)
    cap = GradCapture(opt)
    assigner = TargetAssigner(pcfg.anchor_generator, pcfg.grid_size, pcfg.pc_range,
                              pcfg.class_names, device="cpu")
    step = make_train_step(model, assigner, cap, pcfg.loss_weights, pcfg)
    b = model.batch_to_device(batch)
    if perturb_seed is not None:
        b = perturb_inputs(b, perturb_seed)
    _, tb = step(b)
    return step_record(model, cap, tb), float(lr_schedule(0))


def test_tiny_train_step_b2_matches_jax(tiny):
    """One step at B=2 on two augmented training frames (a Truck among their
    boxes): loss terms, gradients, updated parameters and BN statistics,
    the masked ones over both frames' sites, under ``step_compare``.

    ``TRAIN_SEED`` 5 is an augmentation draw whose step is well conditioned.
    JAX's own step, probed as ``step_compare.sensitivity`` probes the port's
    (inputs moved by 1e-7 relative; 2 probes, 8 for seeds 5 and 6), is not on
    most other draws: its largest sensitivity over a tensor's largest
    gradient reads 0.016 (seed 1), 0.0016 (2), 0.28 (4), 0.10 (7) and 0.14
    (8) against the 1e-3 cap, where the port's reads 0.016, 0.0056, 0.035,
    0.10 and 0.012; seed 5 reads 1.5e-4 (JAX) and 7.4e-4 (the port). Seed 6
    is the exception: JAX 6.3e-4, the port 9.7e-3, both on
    ``pred_occupancy.1.bias``. There the port's first probe flips one ReLU
    after that BatchNorm, whose input sits 2.9e-6 of its channel's std from
    0, and nothing else (tests/torch_relu_flip.py): a conditioning case, as
    JAX's other draws are, not a fault (ROADMAP.md queue 3)."""
    t = tiny
    jcfg, jm = t["jcfg"], t["jm"]
    pcfg = model_config_from_yaml(t["pcfg"])
    train_ds = build_dataset(t["pcfg"]["DATA_CONFIG"], CLASSES, training=True)
    # a seed whose augmentation gives a step the port's own probes find well
    # conditioned: with seeds 1, 2, 4, 6, 7 and 8 a 1e-7 input change flips
    # ReLUs of the radar branch (step_compare.SENS_CAP)
    np.random.seed(TRAIN_SEED)
    batch = device_batch(train_ds.collate_batch([train_ds[i] for i in range(2)]))
    assert batch["points"].shape[0] == 2 and (batch["gt_boxes"][..., -1] == 4).any()
    variables = _zero_residual_scales(t["variables"])
    tx, _ = jax_build_optimizer(jcfg.OPTIMIZATION, total_steps=TOTAL_STEPS,
                                params=variables["params"])
    tx = optax.chain(_capture(), tx)
    assigner = JaxAssigner([dict(c) for c in jcfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG],
                           jm.grid_size, jm.pc_range, class_names=jm.class_names)
    loss_weights = dict(jcfg.MODEL.DENSE_HEAD.LOSS_CONFIG.LOSS_WEIGHTS)
    jstep = jax.jit(jax_make_train_step(t["jmodel"], assigner, tx, loss_weights, jm))
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=jax.jit(tx.init)(variables["params"]),
                       step=np.zeros((), np.int32))
    got, lr = _port_step(pcfg, variables, batch)
    probes = [_port_step(pcfg, variables, batch, s)[0]["grads"] for s in (1, 2)]
    after, tb = jstep(state, batch)
    ref = _jax_record(after, tb, list(got["grads"]))
    report = compare_steps(ref, got, sensitivity(got["grads"], probes), lr)
    print(f"tj4d B=2 step: {report}")
    assert float(got["tb"]["rpn_loss_cls"]) > 0


def test_tiny_run_eval_matches_jax(tiny):
    t = tiny
    model = t["model"]
    with torch.no_grad():
        scores = [torch.sigmoid(model(model.batch_to_device(t["pds"].collate_batch(
            [t["pds"][i]])))["cls_preds"].reshape(-1, 4)).max(-1).values.numpy()
            for i in range(len(t["pds"]))]
    # about 7 candidates a frame: at 8 or more, two of a frame's 40,960
    # random-weight scores fall within SCORE_GAP of each other
    thr = tie_free_threshold(scores, SCORE_GAP, per_frame=7)
    for cfg in (t["pcfg"], t["jcfg"]):
        cfg["MODEL"]["POST_PROCESSING"]["SCORE_THRESH"] = thr
    model.cfg = model_config_from_yaml(t["pcfg"])
    annos, result, stats = port_test.run_eval(t["pcfg"], model, t["pds"], t["logger"])
    jax_annos, jax_result = _jax_tools_test().run_eval(
        t["jcfg"], t["jm"], t["jds"], t["variables"]["params"], t["variables"]["batch_stats"],
        jax_create_logger(), batch_size=1)
    names = np.concatenate([a["name"] for a in annos])
    # every class kept, Truck (label 4, the second anchor set) included
    assert len(names) >= 10 and set(names) == set(CLASSES)
    _assert_annos_close(annos, jax_annos, BOX_TOL)
    assert set(result) == set(jax_result) and "KITTI/Overall_3D_moderate" in result
    for k in result:
        assert abs(result[k] - jax_result[k]) <= RESULT_TOL, k
    assert stats["frames"] == 4 and stats["total_gt"] > 0


def test_tiny_polar_serve_matches_jax(tiny):
    """``hgsfusion_tj4d_polar.yaml`` cut alike: the polar view on TJ4D's
    asymmetric range (x from 0, y about 0), non-square grid and ragged
    image, every head output within 1e-4 of the JAX model's."""
    t = tiny
    root = t["pcfg"]["DATA_CONFIG"]["DATA_PATH"]
    pcfg = tiny_tj4d_cut(load_config(YAMLS["polar"]), root)
    jcfg = ConfigDict(tiny_tj4d_cut(jax_load_config(YAMLS["polar"]), root))
    jm = jax_model_config(jcfg)
    m = model_config_from_yaml(pcfg)
    assert (m.f2v_view, jm.f2v_view) == ("polar", "polar") and m.grid_size == jm.grid_size
    batch = t["pds"].collate_batch([t["pds"][i] for i in range(2)])
    jb = {k: jnp.asarray(v) for k, v in device_batch(batch).items()}
    jmodel = build_network(jcfg, jm)
    variables = perturb_variables(
        jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, False))(jb), seed=2)
    ref, _ = jax.jit(lambda v, b: jmodel.apply(v, b, False, mutable=["batch_stats"]))(
        variables, jb)
    model = load(HGSFusionModel(m, device="cpu"), from_jax_variables(variables))
    with torch.no_grad():
        got = model(model.batch_to_device(batch))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert_close(got[k], np.asarray(ref[k]), atol=HEAD_TOL, rtol=HEAD_TOL, err_msg=k)
