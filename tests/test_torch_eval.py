"""The port's evaluation path against the JAX package's, on the CPU: the
C++ rotated overlap, the KITTI AP core and the official VoD evaluation,
the prediction writer, and the whole loop (``tools/test.py::run_eval``) on
the TINY model, with the pipeline's ordering and error semantics."""
import ctypes
import dataclasses
import importlib.util
import os
import pickle
import subprocess
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hgsfusion_tpu.config import ConfigDict
from hgsfusion_tpu.config import load_config as jax_load_config
from hgsfusion_tpu.config import model_config_from_yaml as jax_model_config
from hgsfusion_tpu.datasets import build_dataset as jax_build_dataset
from hgsfusion_tpu.eval.rotated_iou_np import rotate_iou_eval as jax_rotate_iou_eval
from hgsfusion_tpu.eval.vod_eval import vod_official_eval as jax_vod_official_eval
from hgsfusion_tpu.models.registry import build_network
from hgsfusion_tpu.train.trainer import add_init_anchors, device_batch
from hgsfusion_tpu.utils.common import create_logger as jax_create_logger
from chip_smoke import tie_free_threshold
from hgsfusion_tpu_torch import native
from hgsfusion_tpu_torch.config import load_config, model_config_from_yaml
from hgsfusion_tpu_torch.datasets import build_dataset
from hgsfusion_tpu_torch.datasets.synthetic import make_synthetic_kitti
from hgsfusion_tpu_torch.eval.rotated_iou_np import rotate_iou_eval, rotate_iou_eval_np
from hgsfusion_tpu_torch.eval.vod_eval import vod_official_eval
from hgsfusion_tpu_torch.models.detector import HGSFusionModel
from hgsfusion_tpu_torch.tools import test as port_test
from hgsfusion_tpu_torch.tools.create_infos import create_infos
from hgsfusion_tpu_torch.tools.create_infos import main as create_infos_main
from hgsfusion_tpu_torch.train.checkpoint import KEY_ALIASES, load_checkpoint
from hgsfusion_tpu_torch.utils.common import create_logger
from hgsfusion_tpu_torch.weights import from_jax_variables
from test_model import TINY
from torch_parity import one_torch_thread, port_config, shaped_variables  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
YAML = REPO / "configs" / "hgsfusion_vod_pallas.yaml"
TINY_PALLAS = dataclasses.replace(TINY, f2v_sampler_kernel="pallas")
BOX_TOL, RESULT_TOL = 1e-4, 1e-6
# no two scores that pass SCORE_THRESH, and no score and the threshold, lie
# within SCORE_GAP: 10x the two frameworks' largest score difference on
# these frames (1.1e-8), so the top-k orders agree
SCORE_GAP = 1e-7


def _jax_tools_test():
    """The JAX package's tools/test.py, under a name of its own."""
    spec = importlib.util.spec_from_file_location("jax_tools_test", REPO / "tools" / "test.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _random_boxes5(rng, n):
    b = np.zeros((n, 5))
    b[:, 0:2] = rng.uniform(-20, 20, (n, 2))
    b[:, 2:4] = rng.uniform(0.5, 6.0, (n, 2))
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    return b


@pytest.fixture(scope="module")
def jax_rotate_iou_lib(tmp_path_factory):
    """The JAX package's own C++ source, ``hgsfusion_tpu/native/src/rotate_iou.cc``,
    built here with the port's flags for it (``native.HOST_CXX_FLAGS``, the
    JAX package's) into a directory of this test's own, so the bit-for-bit
    check does not depend on which library a test worker found in the JAX
    package's shared build directory. No compiler fails the test: the port's
    ``native.load_host`` needs one too."""
    src = REPO / "hgsfusion_tpu" / "native" / "src" / "rotate_iou.cc"
    out = tmp_path_factory.mktemp("jax_rotate_iou") / "librotate_iou.so"
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *native.HOST_CXX_FLAGS, str(src), "-o", str(out)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"{cxx} failed for {src}:\n{proc.stdout}{proc.stderr}"
    lib = ctypes.CDLL(str(out))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.rotate_iou_eval.argtypes = [dp, ctypes.c_int64, dp, ctypes.c_int64, ctypes.c_int, dp]
    lib.rotate_iou_eval.restype = None

    def run(a, b, criterion):
        a = np.ascontiguousarray(a, np.float64)
        b = np.ascontiguousarray(b, np.float64)
        out = np.empty((a.shape[0], b.shape[0]), np.float64)
        lib.rotate_iou_eval(a.ctypes.data_as(dp), a.shape[0], b.ctypes.data_as(dp),
                            b.shape[0], int(criterion), out.ctypes.data_as(dp))
        return out
    return run


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
def test_rotate_iou_cpp_matches_numpy(criterion, jax_rotate_iou_lib):
    rng = np.random.RandomState(criterion + 1)
    a, b = _random_boxes5(rng, 40), _random_boxes5(rng, 37)
    b[:10] = a[:10] + rng.normal(0, 0.5, (10, 5))  # overlapping pairs
    got = rotate_iou_eval(a, b, criterion)
    np.testing.assert_allclose(got, rotate_iou_eval_np(a, b, criterion), rtol=0, atol=1e-9)
    assert (got > 0).sum() >= 10
    # the JAX package's source built with the same flags: bit for bit
    np.testing.assert_array_equal(got, jax_rotate_iou_lib(a, b, criterion))
    # the JAX package's own entry point, which may have run its C++ build or
    # (a worker that loaded a half-written library) its numpy fallback
    np.testing.assert_allclose(got, jax_rotate_iou_eval(a, b, criterion), rtol=0, atol=1e-9)


def test_rotate_iou_cpp_edge_cases():
    a = np.array([[0, 0, 4, 2, 0.3]])
    np.testing.assert_allclose(rotate_iou_eval(a, a, -1), [[1.0]], atol=1e-12)
    touching = np.array([[0, 0, 2, 2, 0.0], [2, 0, 2, 2, 0.0]])
    assert abs(rotate_iou_eval(touching, touching, -1)[0, 1]) < 1e-12
    big = np.array([[0, 0, 10, 10, 0.5]])
    inner = np.array([[0, 0, 1, 1, -0.7], [5, 5, 0, 0, 0]])  # inside; zero area
    out = rotate_iou_eval(big, inner, 2)
    np.testing.assert_allclose(out[0, 0], 1.0, atol=1e-9)
    assert out[0, 1] == 0.0
    assert rotate_iou_eval(np.zeros((0, 5)), inner, -1).shape == (0, 2)
    assert rotate_iou_eval(inner, np.zeros((0, 5)), -1).shape == (2, 0)


NAMES = np.array(["Car", "Pedestrian", "Cyclist", "Van", "Person_sitting", "DontCare"])


def _random_frame(rng, n, det: bool):
    loc = np.stack([rng.uniform(-8, 8, n), rng.uniform(0.5, 2.0, n), rng.uniform(3, 40, n)], 1)
    dims = np.stack([rng.uniform(0.5, 4.5, n), rng.uniform(1.2, 2.0, n),
                     rng.uniform(0.5, 2.0, n)], 1)
    x1, y1 = rng.uniform(0, 1800, n), rng.uniform(0, 450, n)
    bbox = np.stack([x1, y1, x1 + rng.uniform(10, 200, n), y1 + rng.uniform(10, 120, n)], 1)
    anno = {"name": NAMES[rng.randint(0, 3 if det else 6, n)],
            "truncated": rng.uniform(0, 0.5, n), "occluded": rng.randint(0, 3, n).astype(float),
            "alpha": rng.uniform(-np.pi, np.pi, n), "bbox": bbox, "dimensions": dims,
            "location": loc, "rotation_y": rng.uniform(-np.pi, np.pi, n)}
    if det:
        anno["score"] = rng.uniform(0.05, 1.0, n)
    return anno


def _jitter(rng, gt):
    """Detections near a frame's gt, some of them off, plus false ones."""
    keep = gt["name"] != "DontCare"
    n = int(keep.sum())
    det = {k: np.array(v)[keep] for k, v in gt.items()}
    det["location"] = det["location"] + rng.normal(0, 0.3, (n, 3))
    det["rotation_y"] = det["rotation_y"] + rng.normal(0, 0.2, n)
    det["bbox"] = det["bbox"] + rng.normal(0, 5, (n, 4))
    det["name"] = np.where(rng.rand(n) < 0.85, det["name"], "Car")
    det["name"] = np.where(np.isin(det["name"], NAMES[:3]), det["name"], "Car")
    det["score"] = rng.uniform(0.05, 1.0, n)
    extra = _random_frame(rng, rng.randint(0, 4), det=True)
    return {k: np.concatenate([det[k], extra[k]]) for k in det}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vod_official_eval_equals_jax(seed):
    rng = np.random.RandomState(seed)
    gt, dt = [], []
    for f in range(12):
        g = _random_frame(rng, 0 if f == 3 else rng.randint(1, 9), det=False)
        gt.append(g)
        dt.append(_random_frame(rng, 0, det=True) if f == 5 else _jitter(rng, g))
    got_str, got = vod_official_eval(gt, dt, ["Car", "Pedestrian", "Cyclist"])
    want_str, want = jax_vod_official_eval(gt, dt, ["Car", "Pedestrian", "Cyclist"])
    assert got == want and got_str == want_str
    assert max(got.values()) > 0  # the jittered detections find some gts


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_vod") / "data"
    make_synthetic_kitti(root, num_frames=5, num_points=256, num_virtual=64,
                         image_hw=(64, 96), structured=True)
    return root


def _tiny_cfg(cfg, root):
    """configs/hgsfusion_vod_pallas.yaml cut to the TINY model of
    tests/test_model.py: 16x8 m range at 0.5 m, a 64x96 image, ResNet-50,
    16 depth bins, f32."""
    data = cfg["DATA_CONFIG"]
    data.update(DATA_PATH=str(root), POINT_CLOUD_RANGE=[0, -8, -3, 16, 8, 2],
                IMAGE_SIZE=[64, 96], MAX_POINTS=1024, MAX_GT_BOXES=16,
                VIRTUAL_POINT_PREFIX="virtual_points")
    data["DATA_PROCESSOR"][1]["VOXEL_SIZE"] = [0.5, 0.5, 0.5]
    model = cfg["MODEL"]
    model["COMPUTE_DTYPE"] = "float32"
    ffn = model["FusionVFE"]["ImageVFE"]["FFN"]
    ffn["DDN"]["BACKBONE_NAME"] = "ResNet50"
    ffn["DISCRETIZE"].update(num_bins=16, depth_max=16.0)
    model["POST_PROCESSING"]["NMS_CONFIG"].update(NMS_PRE_MAXSIZE=512, NMS_POST_MAXSIZE=100)
    return cfg


@pytest.fixture(scope="module")
def tiny_eval(tree):
    """Both frameworks' configs, datasets and one set of weights (the JAX
    init with perturbed BN statistics, carried by from_jax_variables)."""
    pcfg = _tiny_cfg(load_config(YAML), tree)
    jcfg = ConfigDict(_tiny_cfg(jax_load_config(YAML), tree))
    create_infos(pcfg["DATA_CONFIG"], pcfg["CLASS_NAMES"])
    logger = create_logger()
    pds = build_dataset(pcfg["DATA_CONFIG"], pcfg["CLASS_NAMES"], training=False, logger=logger)
    jds = jax_build_dataset(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, training=False,
                            logger=jax_create_logger())
    jm = jax_model_config(jcfg)
    jmodel = build_network(jcfg, jm)
    init_batch = add_init_anchors(
        {k: jnp.asarray(v) for k, v in device_batch(jds.collate_batch([jds[0]])).items()},
        jcfg, jm)
    variables = shaped_variables(jmodel, init_batch, False, seed=2)

    model = HGSFusionModel(model_config_from_yaml(pcfg), device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        scores = [torch.sigmoid(model(model.batch_to_device(pds.collate_batch([pds[i]])))[
            "cls_preds"].reshape(-1, 3)).max(-1).values.numpy() for i in range(len(pds))]
    thr = tie_free_threshold(scores, SCORE_GAP, per_frame=12)
    for cfg in (pcfg, jcfg):
        cfg["MODEL"]["POST_PROCESSING"]["SCORE_THRESH"] = thr
    model.cfg = model_config_from_yaml(pcfg)
    assert model.cfg == port_config(TINY_PALLAS, **{
        f: getattr(model.cfg, f) for f in ("anchor_generator", "loss_weights", "score_thresh",
                                           "nms_thresh", "nms_pre_max_size",
                                           "nms_post_max_size", "optimization")})
    return {"pcfg": pcfg, "jcfg": jcfg, "pds": pds, "jds": jds, "jm": jm,
            "variables": variables, "model": model, "logger": logger}


@pytest.fixture(scope="module")
def port_annos(tiny_eval):
    t = tiny_eval
    annos, result, stats = port_test.run_eval(t["pcfg"], t["model"], t["pds"], t["logger"])
    return annos, result, stats


def _assert_annos_close(got, want, tol=BOX_TOL):
    assert [a["frame_id"] for a in got] == [a["frame_id"] for a in want]
    for g, w in zip(got, want):
        assert list(g["name"]) == list(w["name"]), g["frame_id"]
        for key in ("boxes_lidar", "location", "dimensions", "rotation_y", "score", "bbox"):
            np.testing.assert_allclose(np.asarray(g[key], np.float64),
                                       np.asarray(w[key], np.float64),
                                       rtol=tol, atol=tol, err_msg=f"{g['frame_id']} {key}")


def test_run_eval_matches_jax(tiny_eval, port_annos):
    t = tiny_eval
    jax_annos, jax_result = _jax_tools_test().run_eval(
        t["jcfg"], t["jm"], t["jds"], t["variables"]["params"], t["variables"]["batch_stats"],
        jax_create_logger(), batch_size=1)
    annos, result, stats = port_annos
    assert sum(len(a["name"]) for a in annos) >= 10
    _assert_annos_close(annos, jax_annos)
    assert set(result) == set(jax_result)
    for k in result:
        assert abs(result[k] - jax_result[k]) <= RESULT_TOL, k
    assert stats["frames"] == 5 and stats["total_gt"] > 0
    assert [sum(b.values()) for b in stats["launches_per_batch"]] == [0] * 5  # CPU: no kernel


def test_run_eval_batch_size_invariant(tiny_eval, port_annos):
    """5 frames at B=2 (batches of 2, 2, 1) give B=1's frames in order."""
    t = tiny_eval
    annos, result, _ = port_test.run_eval(t["pcfg"], t["model"], t["pds"], t["logger"],
                                          batch_size=2)
    _assert_annos_close(annos, port_annos[0])
    for k in result:
        assert abs(result[k] - port_annos[1][k]) <= RESULT_TOL, k


@pytest.mark.parametrize("stage", ["producer", "finisher"])
def test_run_eval_errors_surface(tiny_eval, monkeypatch, stage):
    t = tiny_eval

    class Boom(RuntimeError):
        pass

    def boom(*args, **kwargs):
        raise Boom(f"{stage} failed")

    target = "collate_batch" if stage == "producer" else "generate_prediction_dicts"
    monkeypatch.setattr(t["pds"], target, boom)
    before = threading.active_count()
    with pytest.raises(Boom):
        port_test.run_eval(t["pcfg"], t["model"], t["pds"], t["logger"], batch_size=2)
    assert threading.active_count() == before  # both threads ended


def test_prediction_dicts_and_files_equal_jax(tiny_eval, tmp_path):
    t = tiny_eval
    rng = np.random.RandomState(7)
    batch = t["pds"].collate_batch([t["pds"][i] for i in range(3)])
    jbatch = t["jds"].collate_batch([t["jds"][i] for i in range(3)])
    preds = []
    for n in (4, 0, 2):
        boxes = np.concatenate([rng.uniform([2, -6, -2], [14, 6, 0], (n, 3)),
                                rng.uniform(0.5, 4, (n, 3)),
                                rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)
        preds.append({"pred_boxes": boxes, "pred_scores": rng.rand(n).astype(np.float32),
                      "pred_labels": rng.randint(1, 4, n)})
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = t["pds"].generate_prediction_dicts(batch, preds, t["pds"].class_names,
                                             output_path=tmp_path / "port")
    want = t["jds"].generate_prediction_dicts(jbatch, preds, t["jds"].class_names,
                                              output_path=tmp_path / "jax")
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 3
    for name in names:
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


@pytest.fixture(scope="module")
def tiny_yaml(tiny_eval, tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny_pallas.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(tiny_eval["pcfg"], f, sort_keys=False)
    return path


def test_load_checkpoint_formats(tiny_eval, tmp_path):
    model = tiny_eval["model"]
    state = model.state_dict()
    torch.save(state, tmp_path / "port.pth")
    # a pcdet checkpoint: CamelCase FusionVFE names, RadarOccupancy twice,
    # and the DeepLab classifier that USE_DEPTH False leaves unused
    ref = {}
    for k, v in state.items():
        for dst, src in KEY_ALIASES:
            if k.startswith(src):
                k = dst + k[len(src):]
                if dst == "fusion_vfe.RadarOccupancy.":
                    ref["fusion_vfe.radar_occupancy." + k[len(dst):]] = v
                break
        ref[k] = v
    classifier = {f"fusion_vfe.ImageVFE.ffn.ddn.model.classifier.{i}.weight": torch.ones(2)
                  for i in (0, 4)}
    torch.save({"model_state": {**ref, **classifier}, "epoch": 3}, tmp_path / "pcdet.pth")
    for name in ("port.pth", "pcdet.pth"):
        fresh = HGSFusionModel(model.cfg, device="cpu", seed=9)
        unmatched = load_checkpoint(fresh, tmp_path / name)
        assert unmatched == ([] if name == "port.pth" else sorted(
            k.replace("ImageVFE", "image_vfe") for k in classifier))
        for k, v in fresh.state_dict().items():
            assert torch.equal(v, state[k]), (name, k)
    missing = dict(state)
    missing.pop("dense_head.conv_cls.bias")
    torch.save(missing, tmp_path / "missing.pth")
    torch.save({"model_state": missing}, tmp_path / "pcdet_missing.pth")
    torch.save({**state, "extra.weight": torch.zeros(1)}, tmp_path / "extra.pth")
    for name in ("missing.pth", "pcdet_missing.pth", "extra.pth"):
        with pytest.raises(RuntimeError):
            load_checkpoint(HGSFusionModel(model.cfg, device="cpu"), tmp_path / name)


def test_cli_create_infos_then_eval(tiny_eval, tiny_yaml, tmp_path):
    """create_infos and test through their CLIs on the CPU, from a
    checkpoint: two frames, the AP table logged and result.pkl written."""
    create_infos_main(["--cfg_file", str(tiny_yaml)])
    torch.save(tiny_eval["model"].state_dict(), tmp_path / "w.pth")
    port_test.main(["--cfg_file", str(tiny_yaml), "--device", "cpu", "--ckpt",
                    str(tmp_path / "w.pth"), "--max_frames", "2", "--output_dir",
                    str(tmp_path / "out"), "--save_to_file", "--infer_time"])
    out = tmp_path / "out" / "tiny_pallas" / "default" / "eval"
    with open(out / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    assert [a["frame_id"] for a in annos] == ["00000", "00001"]
    log = (out / "eval.log").read_text()
    assert "recall@0.3" in log and "Car" in log
    assert sorted(p.name for p in (out / "final_result").iterdir()) == ["00000.txt", "00001.txt"]


def test_cli_refuses_what_is_not_ported(tiny_yaml):
    with pytest.raises(SystemExit, match="--eval_all requires --ckpt_dir"):
        port_test.main(["--cfg_file", str(tiny_yaml), "--device", "cpu", "--eval_all"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_test.main(["--cfg_file", str(tiny_yaml)])
