"""The port's benchmark entry point (``python -m hgsfusion_tpu_torch.bench``)
on the CPU: its one stdout line and metric names, the error line without a
CUDA device, the configs and batch against ``bench.py``'s
(``__graft_entry__._vod_flagship``), and ``--realistic``'s bias shift
against ``bench.py::_calibrate_realistic`` on the TINY model with the same
weights. The measurement itself runs only on the card (``chip_smoke.py``'s
bench phase)."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jax_bench
from __graft_entry__ import _vod_flagship
from hgsfusion_tpu.models.detector import HGSFusionModel as JaxModel
from hgsfusion_tpu_torch import bench
from hgsfusion_tpu_torch.models.detector import HGSFusionModel
from hgsfusion_tpu_torch.synthetic import flagship_batch
from hgsfusion_tpu_torch.weights import from_jax_variables
from test_model import TINY, make_tiny_batch
from torch_parity import load, one_torch_thread, port_config, shaped_variables  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
LINE_KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.mark.parametrize("argv,metric", [
    ([], "hgsfusion_vod_polar_e2e_inference"),
    (["--vod"], "hgsfusion_vod_e2e_inference"),
    (["--batch", "2"], "hgsfusion_vod_polar_b2_e2e_inference"),
    (["--batch=2", "--vod_pallas"], "hgsfusion_vod_pallas_b2_e2e_inference"),
    (["--realistic"], "hgsfusion_vod_polar_realistic_e2e_inference"),
    (["--tj4d"], "hgsfusion_tj4d_e2e_inference"),
    (["--tj4d", "--batch", "2", "--realistic"], "hgsfusion_tj4d_b2_realistic_e2e_inference"),
])
def test_one_line_and_its_metric(monkeypatch, capsys, argv, metric):
    """Exactly one JSON line on stdout with bench.py's keys, the metric
    named as bench.py names it and vs_baseline = frames/s / (3 x 18); the
    report on stderr, the launch counts on a line of their own."""
    seen = {}

    def run(name, batch_size, realistic):
        seen.update(name=name, batch_size=batch_size, realistic=realistic)
        return {"metric": bench.metric_name(name, batch_size, realistic), "value": 27.0,
                "unit": "frames/sec/chip", "vs_baseline": 27.0 / 54.0,
                "chain_fps": [26.0, 27.0, 28.0], "device_ms_per_frame": [30.0] * 3,
                "peak_memory_bytes": 1, "card": "a card, 700.00 W", "bias_shift": 1.5,
                "kept": 12, "frames_per_chain": 20,
                "launches": {"serve_calls": 60, "counts": {"nms_lazy": 60}}}

    monkeypatch.setattr(bench, "run", run)
    assert bench.main(argv) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == LINE_KEYS and line["metric"] == metric
    assert line["unit"] == "frames/sec/chip" and line["vs_baseline"] == 0.5
    assert seen["batch_size"] == (2 if any("2" in a for a in argv) else 1)
    assert err.startswith("# a card, 700.00 W") and ("realistic regime" in err) == (
        "--realistic" in argv)
    launched = [s for s in err.splitlines() if s.startswith("# launches ")]
    assert [json.loads(s[len("# launches "):]) for s in launched] == [
        {"serve_calls": 60, "counts": {"nms_lazy": 60}}]
    assert (bench.REF_A100_FPS, bench.TARGET_MULTIPLIER) == (jax_bench.REF_A100_FPS,
                                                             jax_bench.TARGET_MULTIPLIER)


@pytest.mark.parametrize("argv", [[], ["--tj4d", "--batch", "2", "--realistic"]])
def test_error_line_without_cuda(monkeypatch, capsys, argv):
    """No CUDA device: one error line (value 0.0, error, detail) and rc 1;
    nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(argv) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == LINE_KEYS | {"error", "detail"}
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert line["error"] == "cuda-unavailable" and "CUDA" in line["detail"]
    assert line["metric"] == bench.metric_name(*bench.parse_argv(argv))


def test_entry_point_exit_code_without_cuda():
    """``python -m hgsfusion_tpu_torch.bench`` in a process that sees no
    CUDA device exits 1 after its one line."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "hgsfusion_tpu_torch.bench", "--vod"],
                          capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 1, proc.stderr
    line = json.loads(proc.stdout.strip())
    assert line["metric"] == "hgsfusion_vod_e2e_inference" and line["value"] == 0.0


@pytest.mark.parametrize("name", ["vod_polar", "vod", "tj4d"])
def test_config_and_batch_are_bench_pys(name):
    """``flagship_config`` + ``flagship_batch`` are ``_vod_flagship``'s
    config (516 x 1936, bf16) and batch, bit for bit in every served key."""
    jax_model, jax_cfg, jax_batch = _vod_flagship(config_path=f"configs/hgsfusion_{name}.yaml",
                                                  b=2)
    cfg = bench.flagship_config(name)
    assert cfg == port_config(jax_cfg, **{f: getattr(cfg, f) for f in (
        "anchor_generator", "loss_weights", "score_thresh", "nms_thresh", "nms_pre_max_size",
        "nms_post_max_size", "optimization")})
    assert cfg.image_size == (516, 1936) and cfg.compute_dtype == "bfloat16"
    batch = flagship_batch(cfg, b=2)
    for k in ("points", "points_valid", "images", "trans_lidar_to_cam", "trans_cam_to_img",
              "lidar_aug_matrix"):
        np.testing.assert_array_equal(batch[k], np.asarray(jax_batch[k]), err_msg=k)


def test_realistic_shift_equals_bench_pys():
    """``calibrate_realistic`` shifts the class head's bias by
    ``_calibrate_realistic``'s delta (1e-5) on the TINY model with the same
    weights and batch (B=2), and about 64 candidates a frame then pass 0.1."""
    tiny = dataclasses.replace(TINY, f2v_sampler_kernel="pallas")
    batch = make_tiny_batch(np.random.RandomState(0), b=2)
    jmodel = JaxModel(cfg=tiny)
    variables = shaped_variables(jmodel, batch, False, seed=1)
    shifted = jax_bench._calibrate_realistic(jmodel, variables, batch)
    before = np.asarray(variables["params"]["dense_head"]["conv_cls"]["bias"])
    after = np.asarray(shifted["params"]["dense_head"]["conv_cls"]["bias"])
    want = float((after - before).mean())

    model = load(HGSFusionModel(port_config(tiny), device="cpu"), from_jax_variables(variables))
    on_device = model.batch_to_device({k: np.asarray(v) for k, v in batch.items()})
    delta = bench.calibrate_realistic(model, on_device)
    assert abs(delta - want) <= 1e-5
    np.testing.assert_allclose(model.dense_head.conv_cls.bias.detach().numpy(), after,
                               rtol=0, atol=1e-5)
    with torch.inference_mode():
        scores = torch.sigmoid(model(on_device)["cls_preds"].float().reshape(2, -1))
    passing = (scores >= 0.1).sum(1)
    assert bool(((passing >= 48) & (passing <= 80)).all()), passing
