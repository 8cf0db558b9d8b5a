"""The port's serving artifact on the CPU: ``tools/export.py`` writes the
served graph with its weights, ``tools/serve.py`` runs it in a process that
imports no model code (``chip_smoke.run_serving_host`` blocks
``hgsfusion_tpu_torch.models`` and JAX), and its detections equal
``HGSFusionModel.serve``'s bit for bit; the artifact against the JAX
package's (``tools/export.py::export_model`` + ``Exported.call``) on the
same weights; the CLIs with ``--ckpt`` / ``--ckpt_dir`` from a training run.
The configs are ``configs/hgsfusion_vod.yaml`` (gather view,
``SAMPLER_KERNEL: xla``) and ``configs/hgsfusion_vod_polar.yaml`` cut to the
TINY model (``test_torch_eval._tiny_cfg``) over a 2-frame synthetic tree."""
import importlib.util
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from chip_smoke import run_serving_host, start_serving_host_run, tie_free_threshold
from hgsfusion_tpu.config import ConfigDict
from hgsfusion_tpu.config import load_config as jax_load_config
from hgsfusion_tpu.config import model_config_from_yaml as jax_model_config
from hgsfusion_tpu.datasets import build_dataset as jax_build_dataset
from hgsfusion_tpu.models.registry import build_network
from hgsfusion_tpu.train.trainer import add_init_anchors, device_batch, model_inputs
from hgsfusion_tpu_torch.config import load_config, model_config_from_yaml
from hgsfusion_tpu_torch.datasets import build_dataset
from hgsfusion_tpu_torch.datasets.synthetic import make_synthetic_kitti
from hgsfusion_tpu_torch.models.detector import HGSFusionModel
from hgsfusion_tpu_torch.ops import library
from hgsfusion_tpu_torch.tools import export as export_cli
from hgsfusion_tpu_torch.tools import serve as serve_cli
from hgsfusion_tpu_torch.tools import train
from hgsfusion_tpu_torch.tools.create_infos import create_infos
from hgsfusion_tpu_torch.train.checkpoint import load_checkpoint
from hgsfusion_tpu_torch.weights import from_jax_variables
from test_torch_eval import _tiny_cfg
from torch_parity import one_torch_thread, shaped_variables  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FRAMES = 2
VIEWS = {"gather": "hgsfusion_vod", "polar": "hgsfusion_vod_polar"}
# the serving host on one thread, as this process: CPU sums then agree bit for bit
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1"}
# detections against JAX's (f32 on both sides; test_torch_eval's bound)
JAX_TOL = 1e-4
SCORE_GAP = 1e-7  # test_torch_eval's: 10x the frameworks' largest score difference


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tree, its infos, the cut YAML of each view and the frames as
    ``.npz`` batches of the served graph's inputs."""
    tmp = tmp_path_factory.mktemp("export")
    root = tmp / "data"
    make_synthetic_kitti(root, num_frames=FRAMES, num_points=256, num_virtual=64,
                         image_hw=(64, 96), structured=True)
    out = {"tmp": tmp, "root": root}
    for view, name in VIEWS.items():
        cfg = _tiny_cfg(load_config(f"configs/{name}.yaml"), root)
        cfg.pop("TAG")
        # every candidate passes: the NMS has 512 to sweep
        cfg["MODEL"]["POST_PROCESSING"]["SCORE_THRESH"] = 0.0
        path = tmp / f"tiny_{view}.yaml"
        path.write_text(yaml.safe_dump(cfg, sort_keys=False))
        out[view] = str(path)
    create_infos(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"])
    ds = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False)
    out["batches"] = [ds.collate_batch([ds[i]]) for i in range(FRAMES)]
    (tmp / "in").mkdir()
    for i, b in enumerate(out["batches"]):
        np.savez(tmp / "in" / f"frame{i}.npz",
                 **{k: np.asarray(b[k]) for k in export_cli.INPUT_KEYS if k in b})
    return out


def _export(setup, view, tag, *extra):
    art = setup["tmp"] / f"{view}_{tag}.pt2"
    res = export_cli.main(["--cfg_file", setup[view], "--device", "cpu", "--out", str(art),
                           *extra])
    return art, res


def _host_args(setup, art, tag):
    return art, setup["tmp"] / "in", setup["tmp"] / f"out_{tag}"


def _serve_equal(setup, view, art, model, tag, proc=None):
    """The serving host's detections (``proc``: its run, started by
    ``start_serving_host_run``) equal ``model.serve``'s bit for bit."""
    summary, dets = run_serving_host(*_host_args(setup, art, tag), env=ONE_THREAD, proc=proc)
    assert summary["frames"] == FRAMES and summary["device"] == "cpu"
    assert not any(summary["launches"].values())  # the CPU: plain versions, no kernel
    assert sorted(dets) == [f"frame{i}" for i in range(FRAMES)]
    kept = 0
    for i, batch in enumerate(setup["batches"]):
        ref = model.serve(batch)
        got = dets[f"frame{i}"]
        assert set(got) == {"boxes", "scores", "labels", "valid"}
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=f"frame {i} {k}")
        kept += int(ref["valid"].sum())
    assert kept > FRAMES
    return summary


@pytest.fixture(scope="module")
def seed_artifacts(setup):
    """Each view's random weights from seed 0, exported by the CLI, and its
    serving host started right after (it runs beside the later exports and
    tests)."""
    out = {}
    for view in VIEWS:
        art, res = _export(setup, view, "seed")
        out[view] = (art, res, start_serving_host_run(*_host_args(setup, art, view),
                                                      env=ONE_THREAD))
    yield out
    for _, _, proc in out.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def seed_programs(seed_artifacts):
    """Each seed artifact's program, loaded once (``torch.export.load``
    takes seconds)."""
    return {view: torch.export.load(str(art)) for view, (art, _, _) in seed_artifacts.items()}


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_export_then_serve_equals_serve(setup, seed_artifacts, seed_programs, view):
    """Random weights from seed 0, exported by the CLI on the first frame,
    served from ``.npz`` in a process without the model code."""
    art, res, proc = seed_artifacts[view]
    assert res["bytes"] == art.stat().st_size > 1e6 and res["device"] == "cpu"
    assert sorted(res["inputs"]) == sorted(k for k in export_cli.INPUT_KEYS
                                           if k in setup["batches"][0])
    assert res["inputs"]["images"]["shape"] == [1, 64, 96, 3]
    program = seed_programs[view]
    ops = {str(n.target) for n in program.graph.nodes if library.NAMESPACE in str(n.target)}
    want = {"gather": {"hgsfusion.quad_sample_reduce_fwd.default"},
            "polar": {"hgsfusion.quad_sample_fwd.default"}}[view]
    assert ops == want | {"hgsfusion.nms_lazy.default"}
    cfg = model_config_from_yaml(load_config(setup[view]))
    summary = _serve_equal(setup, view, art, HGSFusionModel(cfg, device="cpu", seed=0), view,
                           proc)
    assert len(summary["gaps_ms"]) == FRAMES - 1


@pytest.fixture(scope="module")
def trained(setup):
    """Two training steps of the gather view's cut YAML; its checkpoint."""
    out = train.main(["--cfg_file", setup["gather"], "--device", "cpu", "--workers", "0",
                      "--epochs", "1", "--max_steps", "2", "--fix_random_seed",
                      "--output_dir", str(setup["tmp"] / "train")])
    ckpt_dir = setup["tmp"] / "train" / "tiny_gather" / "default" / "ckpt"
    assert out["end_step"] == 2 and (ckpt_dir / "checkpoint_step_2.pth").exists()
    return ckpt_dir


@pytest.mark.parametrize("how", ["ckpt", "ckpt_dir"])
def test_export_a_trained_checkpoint(setup, trained, how):
    """The weights of a 2-step training run (``--ckpt`` file, or
    ``--ckpt_dir`` and its step) are the artifact's; through ``--ckpt`` it
    serves what ``serve`` serves from the same checkpoint."""
    extra = (["--ckpt", str(trained / "checkpoint_step_2.pth")] if how == "ckpt"
             else ["--ckpt_dir", str(trained), "--ckpt_step", "2"])
    art, _ = _export(setup, "gather", how, *extra)
    # the host serves while this process checks the weights
    proc = (start_serving_host_run(*_host_args(setup, art, how), env=ONE_THREAD)
            if how == "ckpt" else None)
    model = HGSFusionModel(model_config_from_yaml(load_config(setup["gather"])), device="cpu")
    load_checkpoint(model, trained / "checkpoint_step_2.pth")
    seed = HGSFusionModel(model.cfg, device="cpu", seed=0)
    assert any(not torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                      seed.state_dict().values()))
    baked = torch.export.load(str(art)).state_dict
    for name, value in model.state_dict().items():
        if f"model.{name}" in baked:
            assert torch.equal(baked[f"model.{name}"], value), name
    assert sum(f"model.{n}" in baked for n, _ in model.named_parameters()) == len(
        list(model.parameters()))
    if how == "ckpt":
        _serve_equal(setup, "gather", art, model, how, proc)


def test_serving_host_checks_its_inputs(setup, seed_artifacts, seed_programs, tmp_path):
    art, res, _ = seed_artifacts["gather"]
    module, spec = serve_cli.load_artifact(art)
    assert spec["inputs"] == res["inputs"]
    with np.load(setup["tmp"] / "in" / "frame0.npz") as data:
        good = dict(data)
    assert set(serve_cli.batch_inputs(good, spec)) == set(spec["inputs"])
    with pytest.raises(ValueError, match="pins"):
        serve_cli.batch_inputs({**good, "images": good["images"][:, :32]}, spec)
    with pytest.raises(ValueError, match="pins"):
        serve_cli.batch_inputs({**good, "points": good["points"].astype(np.float64)}, spec)
    with pytest.raises(ValueError, match="missing"):
        serve_cli.batch_inputs({k: v for k, v in good.items() if k != "points"}, spec)
    # an artifact of the card on a host without one: refused, not run on the CPU
    export_cli.save_artifact(seed_programs["gather"], {**spec, "device": "cuda"},
                             tmp_path / "cuda.pt2")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_cli.load_artifact(tmp_path / "cuda.pt2")


def _jax_tools_export():
    """The JAX package's tools/export.py, under a name of its own."""
    spec = importlib.util.spec_from_file_location("jax_tools_export",
                                                  REPO / "tools" / "export.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_artifact_matches_jax_export(setup, tmp_path):
    """Both packages' artifacts of one set of weights (random, in the shapes
    of JAX's init, BN statistics not the identity: ``shaped_variables``,
    which compiles nothing; carried by ``from_jax_variables``) on the
    gather view's cut YAML, at a tie-free score threshold baked into both:
    the same kept boxes and labels, boxes and scores within 1e-4."""
    pcfg = load_config(setup["gather"])
    jcfg = ConfigDict(jax_load_config(setup["gather"]))
    jds = jax_build_dataset(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, training=False)
    jm = jax_model_config(jcfg)
    jmodel = build_network(jcfg, jm)
    example = {k: jnp.asarray(v) for k, v in device_batch(jds.collate_batch([jds[0]])).items()}
    variables = shaped_variables(jmodel, add_init_anchors(model_inputs(example), jcfg, jm),
                                 False, seed=2)

    model = HGSFusionModel(model_config_from_yaml(pcfg), device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        scores = [torch.sigmoid(model(model.batch_to_device(b))["cls_preds"].reshape(-1, 3))
                  .max(-1).values.numpy() for b in setup["batches"]]
    thr = tie_free_threshold(scores, SCORE_GAP, per_frame=12)
    pcfg["MODEL"]["POST_PROCESSING"]["SCORE_THRESH"] = thr
    jcfg.MODEL.POST_PROCESSING.SCORE_THRESH = thr
    model.cfg = model_config_from_yaml(pcfg)

    program, spec = export_cli.export_model(model, setup["batches"][0])
    export_cli.save_artifact(program, spec, tmp_path / "port.pt2")
    module, spec = serve_cli.load_artifact(tmp_path / "port.pt2")
    jax_export = _jax_tools_export()
    exported = jax_export.export_model(jcfg, jm, variables["params"], variables["batch_stats"],
                                       example)
    kept = 0
    for i, batch in enumerate(setup["batches"]):
        with torch.inference_mode():
            got = module(serve_cli.batch_inputs(batch, spec))
        jb = {k: jnp.asarray(v) for k, v in device_batch(batch).items()}
        want = {k: np.asarray(v) for k, v in exported.call(model_inputs(jb)).items()}
        valid = want["valid"]
        np.testing.assert_array_equal(got["valid"].numpy(), valid, err_msg=f"frame {i}")
        np.testing.assert_array_equal(got["labels"].numpy()[valid], want["labels"][valid])
        for k in ("boxes", "scores"):
            np.testing.assert_allclose(got[k].numpy()[valid], want[k][valid], rtol=JAX_TOL,
                                       atol=JAX_TOL, err_msg=f"frame {i} {k}")
        kept += int(valid.sum())
    assert kept >= FRAMES
