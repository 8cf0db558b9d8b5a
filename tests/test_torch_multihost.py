"""The port's multi-process evaluation (``parallel/multihost.py``,
``tools/test.py::run_eval`` under a process group) against the JAX
package's ``parallel/multihost.py``, on the CPU.

- ``shard_indices_for_host`` equals JAX's for every frame count and
  process count of the grid (JAX's process index and count patched);
- the annotation merge equals JAX's shared-directory merge on the same
  parts, and the recall scalars sum;
- ``run_eval`` in 2 gloo ranks over a 5-frame tree (the second rank's shard
  padded with frame 0) returns one process's annotations, result dict and
  recall counts exactly, at a tie-free score threshold. The JAX package
  counts the padded duplicate's gt in the recall a second time; the port
  counts every frame once (``multihost.is_padding``).
"""
import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

import torch_dist
from chip_smoke import tie_free_threshold
from hgsfusion_tpu.parallel import multihost as jax_multihost
from hgsfusion_tpu_torch.config import load_config, model_config_from_yaml
from hgsfusion_tpu_torch.datasets import build_dataset
from hgsfusion_tpu_torch.datasets.synthetic import make_synthetic_kitti
from hgsfusion_tpu_torch.models.detector import HGSFusionModel
from hgsfusion_tpu_torch.parallel import multihost, spawn
from hgsfusion_tpu_torch.tools.create_infos import create_infos
from hgsfusion_tpu_torch.tools.test import run_eval
from hgsfusion_tpu_torch.utils.common import create_logger
from test_torch_eval import _tiny_cfg
from torch_parity import one_torch_thread  # noqa: F401

FRAMES = 5
WEIGHT_SEED = 5


@pytest.mark.parametrize("processes", [1, 2, 3, 4])
@pytest.mark.parametrize("frames", [0, 1, 3, 7, 10])
def test_shard_indices_match_jax(monkeypatch, frames, processes):
    monkeypatch.setattr(jax, "process_count", lambda: processes)
    shards, kept = [], []
    for p in range(processes):
        want = jax_multihost.shard_indices_for_host(frames, p)
        got = multihost.shard_indices_for_host(frames, p, processes)
        assert got == want, p
        shards.append(got)
        pad = multihost.is_padding(frames, p, processes)
        assert len(pad) == len(got)
        kept += [i for i, padded in zip(got, pad) if not padded]
    assert len({len(s) for s in shards}) == 1  # equal shards on every process
    # the entries that are not padding: every frame once
    assert sorted(kept) == list(range(frames))


def _jax_merge(parts, frames, tmp_path, monkeypatch):
    """JAX's merge, each process's call in turn, the last process first (the
    barrier a no-op): each call writes its part, and process 0's, the last,
    reads every part (the earlier ones stop at the parts not yet written)."""
    from jax.experimental import multihost_utils

    monkeypatch.setattr(jax, "process_count", lambda: len(parts))
    monkeypatch.setattr(multihost_utils, "sync_global_devices", lambda name: None)
    for p in reversed(range(1, len(parts))):
        monkeypatch.setattr(jax, "process_index", lambda p=p: p)
        with pytest.raises(FileNotFoundError):
            jax_multihost.merge_anno_lists_across_hosts(parts[p], frames, tmp_path)
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    return jax_multihost.merge_anno_lists_across_hosts(parts[0], frames, tmp_path)


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    """One process's ``run_eval`` and two ranks', over the same tree, weights
    and tie-free threshold, on one torch thread each (CPU sums depend on
    the thread count)."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("multihost")
    root = tmp / "data"
    make_synthetic_kitti(root, num_frames=FRAMES, num_points=256, num_virtual=64,
                         image_hw=(64, 96), structured=True)
    cfg = _tiny_cfg(load_config("configs/hgsfusion_vod.yaml"), root)
    create_infos(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"])
    logger = create_logger()
    ds = build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False, logger=logger)
    model_cfg = model_config_from_yaml(cfg)
    model = HGSFusionModel(model_cfg, device="cpu", seed=WEIGHT_SEED)
    with torch.no_grad():
        scores = [torch.sigmoid(model(model.batch_to_device(ds.collate_batch([ds[i]])))[
            "cls_preds"].reshape(-1, model_cfg.num_class)).max(-1).values.numpy()
            for i in range(FRAMES)]
    thr = tie_free_threshold(scores, 1e-7, per_frame=4)
    cfg["MODEL"]["POST_PROCESSING"]["SCORE_THRESH"] = thr
    model_cfg = dataclasses.replace(model_cfg, score_thresh=thr)
    model.cfg = model_cfg
    one = run_eval(cfg, model, ds, logger)
    ranks = spawn.spawn_ranks(torch_dist.eval_rank, 2, cfg, model_cfg, WEIGHT_SEED, FRAMES)
    return {"one": one, "ranks": ranks}


def _annos_equal(a, b):
    assert [x["frame_id"] for x in a] == [x["frame_id"] for x in b]
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{x['frame_id']} {k}")
            else:
                assert x[k] == y[k], k


def test_two_rank_run_eval_equals_one_process(evals):
    annos, result, stats = evals["one"]
    assert sum(len(a["name"]) for a in annos) >= FRAMES
    for r in evals["ranks"]:
        _annos_equal(r["annos"], annos)
        assert r["result"] == result
        assert r["stats"]["recall"] == stats["recall"]
        assert r["stats"]["total_gt"] == stats["total_gt"] > 0
        assert r["stats"]["frames"] == FRAMES and r["stats"]["frames_served"] == 3
    assert [r["shard"] for r in evals["ranks"]] == [[0, 2, 4], [1, 3, 0]]
    # what rank 0 writes to result.pkl reads back as one process's list
    _annos_equal(pickle.loads(pickle.dumps(evals["ranks"][0]["annos"])), annos)


def test_merge_matches_jax(evals, tmp_path, monkeypatch):
    parts = [[f"frame {i}" for i in r["shard"]] for r in evals["ranks"]]
    want = _jax_merge(parts, FRAMES, tmp_path, monkeypatch)
    assert want == [f"frame {i}" for i in range(FRAMES)]
    for r in evals["ranks"]:
        assert r["merged"] == want
        assert r["scalars"] == {"a": 3.0, "b": 1.0}


def test_one_process_merge_is_the_part():
    assert multihost.merge_anno_lists_across_hosts([1, 2, 3, 0], 3) == [1, 2, 3]
    assert multihost.allreduce_host_scalars({"x": 2}) == {"x": 2}
