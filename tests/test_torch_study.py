"""The port's study tools (``tools/make_study_data.py``,
``tools/study_polar_match.py``) against the JAX package's, on the CPU.

- Both tools build the VoD and TJ4D trees, and their hard-val variants, at
  a shrunk ``SPECS`` (patched here in both modules): every file byte for
  byte, the PNG images (TJ4D) pixel for pixel (this package writes PNG with
  other bytes), and the loaded info files equal.
- Both match tools, run on the same two ``result.pkl`` files against the
  same infos, write equal JSON reports (the match statistics, both runs'
  official AP, the deltas).
"""
import importlib.util
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

from hgsfusion_tpu_torch.datasets import image_io
from hgsfusion_tpu_torch.tools import make_study_data, study_polar_match
from test_torch_data import _assert_tree_equal
from torch_parity import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SMALL = {"num_points": 256, "num_virtual": 64, "num_boxes": 4, "image_hw": (172, 640)}
CASES = [("vod", False), ("tj4d", False), ("vod", True), ("tj4d", True)]
FRAMES, VAL = 6, 2


def _jax_tool(name):
    """The JAX package's tools/<name>.py, under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root):
    return sorted(p.relative_to(root) for p in Path(root).rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Each case's tree from both tools, under the shrunk SPECS."""
    jax_tool = _jax_tool("make_study_data")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_tool, make_study_data):
            for name in ("vod", "tj4d"):
                mp.setitem(mod.SPECS, name, {**mod.SPECS[name], **SMALL})
        for name, hard in CASES:
            root = tmp_path_factory.mktemp(f"{name}{'_hard' if hard else ''}")
            out[(name, hard)] = (
                jax_tool.build(name, root / "jax", FRAMES, VAL, hard_val=hard),
                make_study_data.build(name, root / "port", FRAMES, VAL, hard_val=hard))
    return out


@pytest.mark.parametrize("name, hard", CASES)
def test_trees_match_jax(trees, name, hard):
    want_root, got_root = trees[(name, hard)]
    files = _files(want_root)
    assert files == _files(got_root)
    assert any(f.suffix == ".pkl" for f in files)
    for rel in files:
        a, b = want_root / rel, got_root / rel
        if rel.suffix == ".png":
            np.testing.assert_array_equal(image_io.read_image(b), image_io.read_image(a),
                                          err_msg=str(rel))
        elif rel.suffix == ".pkl":
            with open(a, "rb") as fa, open(b, "rb") as fb:
                _assert_tree_equal(pickle.load(fb), pickle.load(fa), str(rel))
        else:
            assert a.read_bytes() == b.read_bytes(), rel
    val = (got_root / "ImageSets" / "val.txt").read_text().split()
    assert len(val) == (FRAMES if hard else VAL)


def _result_pkls(infos, tmp, seed):
    """Two runs' annotation lists made from the gt: boxes moved a little,
    scores drawn, some boxes dropped and some added, run B close to run A."""
    rng = np.random.RandomState(seed)
    runs = {"a": [], "b": []}
    for info in infos:
        gt = info["annos"]
        keep = gt["name"] != "DontCare"
        n = int(keep.sum())
        base = {"name": gt["name"][keep], "location": gt["location"][keep] + rng.normal(0, .2, (n, 3)),
                "dimensions": gt["dimensions"][keep] * rng.uniform(.9, 1.1, (n, 3)),
                "rotation_y": gt["rotation_y"][keep] + rng.normal(0, .1, n),
                "bbox": gt["bbox"][keep], "score": rng.uniform(0.05, 1.0, n)}
        for run, jitter in (("a", 0.0), ("b", 0.05)):
            d = {k: np.array(v, copy=True) for k, v in base.items()}
            d["location"] = d["location"] + rng.normal(0, jitter, (n, 3))
            d["score"] = np.clip(d["score"] + rng.normal(0, jitter, n), 0, 1)
            drop = rng.rand(n) < 0.15
            d = {k: v[~drop] for k, v in d.items()}
            d.update(alpha=np.zeros(len(d["name"])), truncated=np.zeros(len(d["name"])),
                     occluded=np.zeros(len(d["name"])), boxes_lidar=np.zeros((len(d["name"]), 7)))
            runs[run].append(d)
    paths = {}
    for run, annos in runs.items():
        paths[run] = tmp / f"result_{run}.pkl"
        with open(paths[run], "wb") as f:
            pickle.dump(annos, f)
    return paths


@pytest.mark.parametrize("name", ["vod", "tj4d"])
def test_match_reports_match_jax(trees, tmp_path, monkeypatch, name):
    root = trees[(name, True)][1]
    infos_path = root / "kitti_infos_val.pkl"
    with open(infos_path, "rb") as f:
        infos = pickle.load(f)
    paths = _result_pkls(infos, tmp_path, seed=3)
    argv = ["--a", str(paths["a"]), "--b", str(paths["b"]), "--infos", str(infos_path),
            "--dataset", name, "--json"]
    got = study_polar_match.main(argv + [str(tmp_path / "port.json")])
    monkeypatch.setattr(sys, "argv", ["study_polar_match.py"] + argv
                        + [str(tmp_path / "jax.json")])
    _jax_tool("study_polar_match").main()
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == want
    rates = [m["match_rate"] for m in got["match"].values() if m["n_a"]]
    assert rates and 0 < min(rates) < 1  # some boxes matched, some not
    assert got["max_abs_dap"] > 0
