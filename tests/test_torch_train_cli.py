"""The port's training CLI (``tools/train.py``), its checkpoints
(``train/checkpoint.py``) and ``tools/test.py --ckpt_dir / --eval_all``, on
the CPU: ``configs/hgsfusion_vod.yaml`` cut to the TINY model over a 4-frame
synthetic tree (one epoch is 4 steps at B=1)."""
import logging

import numpy as np
import pytest
import torch
import yaml

from hgsfusion_tpu_torch.config import load_config
from hgsfusion_tpu_torch.datasets.synthetic import make_synthetic_kitti
from hgsfusion_tpu_torch.models.detector import RadarOnlyModel
from hgsfusion_tpu_torch.models.registry import yaml_network_class
from hgsfusion_tpu_torch.tools import test as port_test
from hgsfusion_tpu_torch.tools import train
from hgsfusion_tpu_torch.tools.create_infos import create_infos
from hgsfusion_tpu_torch.train.checkpoint import CheckpointManager
from test_cli import _write_cfg
from test_torch_eval import _tiny_cfg
from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tree, its infos and the cut YAML (``tiny.yaml``)."""
    tmp = tmp_path_factory.mktemp("train_cli")
    root = tmp / "data"
    make_synthetic_kitti(root, num_frames=4, num_points=256, num_virtual=64,
                         image_hw=(64, 96), structured=True)
    cfg = _tiny_cfg(load_config("configs/hgsfusion_vod.yaml"), root)
    cfg.pop("TAG")
    create_infos(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"])
    path = tmp / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return {"tmp": tmp, "yaml": str(path)}


def _argv(setup, *extra, tag="default"):
    return ["--cfg_file", setup["yaml"], "--device", "cpu", "--workers", "0", "--epochs", "1",
            "--output_dir", str(setup["tmp"] / "out"), "--extra_tag", tag, *extra]


@pytest.fixture(scope="module")
def runs(setup):
    """Two steps and a checkpoint; then a resume, checked against the file
    before it trains the epoch's last two steps."""
    first = train.main(_argv(setup, "--max_steps", "2", "--fix_random_seed"))
    run = train.prepare(train.parse_args(_argv(setup, "--max_steps", "2", "--fix_random_seed")))
    saved = torch.load(run.ckpt.path(2), map_location="cpu", weights_only=True)
    restored = {"model": {k: v.clone() for k, v in run.model.state_dict().items()},
                "optimizer": {k: (v.clone() if torch.is_tensor(v) else [x.clone() for x in v])
                              for k, v in run.optimizer.state_dict().items()}}
    second = train.fit(run)
    return {"first": first, "second": second, "saved": saved, "restored": restored,
            "ckpt_dir": run.ckpt.ckpt_dir, "log": (run.out_dir / "train.log").read_text()}


def test_two_steps_then_a_checkpoint(runs):
    first = runs["first"]
    assert (first["start_step"], first["end_step"], first["steps"]) == (0, 2, 2)
    assert all(np.isfinite(first["losses"]))
    assert [s["step"] for s in first["saves"]] == [2]
    assert first["saves"][0]["bytes"] > 0 and len(first["loader_wait_s"]) == 2
    assert first["augmentation"]["frames"] == 2
    assert runs["saved"]["step"] == 2 and set(runs["saved"]) == {
        "model_state", "optimizer_state", "step"}


def test_resume_restores_the_saved_state_bit_for_bit(runs):
    saved, restored = runs["saved"], runs["restored"]
    assert set(restored["model"]) == set(saved["model_state"])
    for k, v in saved["model_state"].items():
        assert torch.equal(restored["model"][k], v), k
    opt = saved["optimizer_state"]
    assert int(opt["count"]) == 2 and torch.equal(restored["optimizer"]["count"], opt["count"])
    for key in ("mu", "nu"):
        assert len(restored["optimizer"][key]) == len(opt[key])
        for a, b in zip(restored["optimizer"][key], opt[key]):
            assert torch.equal(a, b)
    assert any(bool(m.any()) for m in opt["mu"])  # the moments were saved, not zeros


def test_resume_continues_to_the_epoch_end(runs):
    second = runs["second"]
    assert (second["resumed_from"], second["start_step"], second["end_step"]) == (2, 2, 4)
    assert "auto-resumed from step 2" in runs["log"]
    # the epoch boundary saves step 4; the final save at 4 keeps that file
    assert [s["step"] for s in second["saves"]] == [4]
    assert "checkpoint step 4 already exists" in runs["log"]
    assert CheckpointManager(runs["ckpt_dir"]).all_steps() == [2, 4]


def test_ckpt_file_starts_with_a_fresh_optimizer(setup, runs):
    path = runs["ckpt_dir"] / "checkpoint_step_4.pth"
    run = train.prepare(train.parse_args(_argv(setup, "--ckpt", str(path), tag="from_file")))
    saved = torch.load(path, map_location="cpu", weights_only=True)["model_state"]
    for k, v in run.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert (run.start_step, run.resumed_from, int(run.optimizer.count)) == (0, None, 0)
    assert not any(bool(m.any()) for m in run.optimizer.mu)


@pytest.mark.parametrize("how", ["newest", "step", "eval_all"])
def test_eval_reads_the_checkpoints(setup, runs, how):
    argv = ["--cfg_file", setup["yaml"], "--device", "cpu", "--max_frames", "2",
            "--ckpt_dir", str(runs["ckpt_dir"]), "--output_dir", str(setup["tmp"] / "eval")]
    extra = {"newest": [], "step": ["--ckpt_step", "2"],
             "eval_all": ["--eval_all", "--max_waiting_mins", "0"]}[how]
    results = port_test.main(argv + extra)
    assert sorted(results) == {"newest": [4], "step": [2], "eval_all": [2, 4]}[how]
    for result_dict, stats in results.values():
        assert stats["frames"] == 2 and set(result_dict)


def test_manager_prunes_skips_truncated_and_keeps_duplicates(tmp_path, caplog):
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2, log=logging.getLogger("ckpt_test"))
    for step in (1, 2, 3):
        info = mgr.save(step, {"model_state": {"w": torch.full((3,), float(step))}})
        assert info["step"] == step and info["bytes"] > 0
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert not list((tmp_path / "ckpt").glob("*.tmp"))
    # a save at a saved step keeps the older file
    with caplog.at_level(logging.INFO):
        assert mgr.save(3, {"model_state": {"w": torch.zeros(3)}}) is None
    assert "already exists" in caplog.text
    state, step = mgr.restore()
    assert step == 3 and torch.equal(state["model_state"]["w"], torch.full((3,), 3.0))
    # a newest file cut short (a crash while writing) is skipped with a warning
    good = mgr.path(3).read_bytes()
    mgr.path(4).write_bytes(good[: len(good) // 2])
    with caplog.at_level(logging.WARNING):
        state, step = mgr.restore()
    assert step == 3 and "does not load" in caplog.text
    assert mgr.restore(step=2)[1] == 2
    assert CheckpointManager(tmp_path / "empty").restore() == (None, None)


def test_cli_refusals(setup, tmp_path):
    # a family the port does not build (queue 1 item 9) raises; the
    # radar-only PillarNet config is built (its training: test_torch_radar_only.py)
    _write_cfg(tmp_path / "pillarnet.yaml", tmp_path / "data")
    assert yaml_network_class(load_config(tmp_path / "pillarnet.yaml")) is RadarOnlyModel
    with pytest.raises(NotImplementedError, match="PointRCNN is not ported.*queue 1 item 9"):
        train.main(["--cfg_file", str(tmp_path / "pillarnet.yaml"), "--device", "cpu",
                    "--set", "MODEL.NAME", "PointRCNN"])
    with pytest.raises(SystemExit, match="dataset is empty"):
        train.main(_argv(setup, "--set", "DATA_CONFIG.DATA_PATH", str(tmp_path)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--cfg_file", setup["yaml"]])
