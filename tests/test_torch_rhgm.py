"""RHGM through the port against the JAX package, on the CPU.

The generator (``rhgm/generator.py``, numpy on the host in both packages)
is held bit for bit to the JAX generator under one ``RandomState`` seed, on
the cases of ``tests/test_rhgm.py`` and on equal-distance kNN ties between
integer pixels. The tool (``python -m
hgsfusion_tpu_torch.tools.generate_hybrid_points``) writes files byte for
byte equal to the JAX tool's for the ``gtbox`` and ``precomputed`` sources
on a VoD and a TJ4D tree. The ``model`` source runs the tiny preset on the
CPU with the published-format ``.pkl`` of ``tests/ref_mask2former.py`` and
``--resize_shortest``: its masks equal the torch oracle's but for pixels
whose logit lies within MASK_LOGIT_TOL of 0, and its files equal those of
the ``precomputed`` source fed with its own masks.
"""
import importlib.util
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hgsfusion_tpu.rhgm import generator as jax_gen
from hgsfusion_tpu_torch.datasets.image_io import read_image
from hgsfusion_tpu_torch.datasets.synthetic import make_synthetic_kitti, make_synthetic_tj4d
from hgsfusion_tpu_torch.rhgm import generator as gen
from hgsfusion_tpu_torch.tools import generate_hybrid_points as tool
from torch_parity import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
L2C = np.array([[0, -1, 0, 0.1], [0, 0, -1, -0.2], [1, 0, 0, 0.3], [0, 0, 0, 1]], np.float32)
C2I = np.array([[200.0, 0, 128, 0], [0, 200, 64, 0], [0, 0, 1, 0]], np.float32)
HW = (128, 256)
# f32 logits of the port and of the torch oracle differ in their last bits:
# a binary mask pixel may differ only where the oracle's logit is this close to 0
MASK_LOGIT_TOL = 1e-4


def _cluster(rng, n=40):
    pts = np.zeros((n, 7), np.float32)
    pts[:, 0] = rng.uniform(9, 11, n)
    pts[:, 1] = rng.uniform(-1, 1, n)
    pts[:, 2] = rng.uniform(-1.0, 0.0, n)
    pts[:, 3:] = rng.randn(n, 4)
    uvd, _ = gen.project_points_to_image(pts[:, :3], L2C, C2I)
    x1, x2 = int(uvd[:, 0].min()) - 10, int(uvd[:, 0].max()) + 10
    y1, y2 = int(uvd[:, 1].min()) - 10, int(uvd[:, 1].max()) + 10
    masks, labels = gen.masks_from_gt_boxes2d([[x1, y1, x2, y2]], [0], HW)
    return masks, labels, pts


def _points_at_pixels(pix, depth, rng, feats: int = 4):
    """Radar points whose projections floor to the integer pixels ``pix``."""
    uv = np.asarray(pix, np.float32) + 0.5
    xyz = gen.back_project(uv, np.full(len(uv), depth, np.float32), L2C, C2I)
    return np.concatenate([xyz, rng.randn(len(uv), feats)], 1).astype(np.float32)


def _case(name, rng):
    """(masks, labels, points, num_virtual) of one generator case."""
    masks, labels, pts = _cluster(rng)
    if name == "basic":
        return masks, labels, pts, 40
    if name == "no_masks":
        return np.zeros((0,) + HW, bool), np.zeros(0, np.int64), pts, 40
    if name == "no_points":
        return masks, labels, pts[:0], 40
    if name == "mask_without_hits":
        corner, _ = gen.masks_from_gt_boxes2d([[0, 0, 20, 20]], [1], HW)
        return np.concatenate([masks, corner]), np.array([0, 1]), pts, 40
    if name == "empty_mask":
        return (np.concatenate([np.zeros_like(masks), masks, np.zeros_like(masks)]),
                np.array([4, 0, 5]), pts, 40)
    if name == "overlapping":
        return np.concatenate([masks, masks]), np.array([0, 3]), pts, 40
    if name == "small_mask":
        uvd, _ = gen.project_points_to_image(pts[:1, :3], L2C, C2I)
        x0, y0 = int(uvd[0, 0]), int(uvd[0, 1])
        tiny = np.zeros_like(masks)
        tiny[0, y0 - 1:y0 + 2, x0 - 1:x0 + 2] = True
        return tiny, labels, pts, 40
    if name == "knn_ties":
        # real points 4 px left and right of a 1-px column, and 4 px above
        # and below a row: every pixel of the column (row) has two or more
        # real points at the same integer distance
        col = np.zeros((1,) + HW, bool)
        col[0, 30:90, 100] = True
        row = np.zeros((1,) + HW, bool)
        row[0, 60, 150:220] = True
        left_right = [(96, y) for y in range(30, 90, 6)] + [(104, y) for y in range(30, 90, 6)]
        up_down = [(x, 56) for x in range(150, 220, 7)] + [(x, 64) for x in range(150, 220, 7)]
        # one point inside each mask too, so each mask has an attributed hit
        p = _points_at_pixels(left_right + up_down + [(100, 31), (151, 60)], 12.0, rng)
        wide = np.zeros((2,) + HW, bool)
        wide[0, 30:90, 92:109] = True  # the column's mask holds its side points
        wide[1, 52:69, 150:220] = True
        return (np.concatenate([col, row, wide]), np.array([2, 0, 2, 0]), p, 30)
    if name == "many_masks":
        n = 200
        p = _points_at_pixels(np.stack([rng.randint(0, HW[1], n), rng.randint(0, HW[0], n)], 1),
                              1.0, rng)
        p[:, :3] *= rng.uniform(5, 30, (n, 1)).astype(np.float32)
        m = np.zeros((6,) + HW, bool)
        for i in range(6):
            y, x = rng.randint(0, HW[0] - 20), rng.randint(0, HW[1] - 30)
            m[i, y:y + rng.randint(5, 60), x:x + rng.randint(5, 90)] = True
        return m, rng.randint(0, 8, 6), p, 100
    raise KeyError(name)


CASES = ["basic", "no_masks", "no_points", "mask_without_hits", "empty_mask", "overlapping",
         "small_mask", "knn_ties", "many_masks"]


@pytest.mark.parametrize("name", CASES)
def test_generator_bit_equal(name):
    masks, labels, pts, nv = _case(name, np.random.RandomState(CASES.index(name)))
    want = jax_gen.generate_hybrid_points(masks, labels, pts, L2C, C2I, num_virtual=nv,
                                          rng=np.random.RandomState(5))
    got = gen.generate_hybrid_points(masks, labels, pts, L2C, C2I, num_virtual=nv,
                                     rng=np.random.RandomState(5))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if name in ("basic", "knn_ties", "many_masks", "small_mask"):
        assert len(got["virtual_points"]) > 0


def test_knn_ties_are_ties():
    """The tie case really holds equal kNN distances (else it tests nothing)."""
    masks, _, pts, _ = _case("knn_ties", np.random.RandomState(CASES.index("knn_ties")))
    uvd, _ = gen.project_points_to_image(pts[:, :3], L2C, C2I)
    rp = np.floor(uvd[:, :2])
    v = np.array([100.0, 40.0])
    d = np.linalg.norm((v - rp).astype(np.float32), axis=1)
    assert np.sum(d == np.sort(d)[0]) >= 2


def test_geometry_and_gtbox_masks_equal():
    rng = np.random.RandomState(3)
    pts = rng.uniform([5, -5, -2], [30, 5, 1], (50, 3)).astype(np.float32)
    for a, b in zip(gen.project_points_to_image(pts, L2C, C2I),
                    jax_gen.project_points_to_image(pts, L2C, C2I)):
        np.testing.assert_array_equal(a, b)
    uvd, _ = gen.project_points_to_image(pts, L2C, C2I)
    np.testing.assert_array_equal(gen.back_project(uvd[:, :2], uvd[:, 2], L2C, C2I),
                                  jax_gen.back_project(uvd[:, :2], uvd[:, 2], L2C, C2I))
    np.testing.assert_array_equal(gen.gaussian_kernel(), jax_gen.gaussian_kernel())
    boxes = [[-3.2, 4.5, 40.6, 70.1], [100, 20, 300, 140]]
    for a, b in zip(gen.masks_from_gt_boxes2d(boxes, [2, 7], HW),
                    jax_gen.masks_from_gt_boxes2d(boxes, [2, 7], HW)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- the tool
def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_hybrid_points", REPO / "tools" / "generate_hybrid_points.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TREES = {"vod": dict(image_hw=(48, 72)), "tj4d": dict(image_hw=(50, 80))}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("rhgm_trees")
    make_synthetic_kitti(root / "vod", num_frames=3, num_points=256, structured=True,
                         **TREES["vod"])
    make_synthetic_tj4d(root / "tj4d", num_frames=3, num_points=256, box_x0=6.0,
                        box_spread=20.0, **TREES["tj4d"])
    return root


def _write_masks(tree: Path, out: Path, hw, seed: int):
    rng = np.random.RandomState(seed)
    out.mkdir(parents=True, exist_ok=True)
    for f in sorted((tree / "training/velodyne").glob("*.bin")):
        m = np.zeros((5,) + hw, bool)
        for i in range(5):
            y, x = rng.randint(0, hw[0] - 8), rng.randint(0, hw[1] - 8)
            m[i, y:y + rng.randint(4, 30), x:x + rng.randint(4, 40)] = True
        m[3] = False  # an empty mask, dropped by both tools
        np.savez(out / f"{f.stem}.npz", masks=m, labels=rng.randint(0, 8, 5),
                 scores=rng.uniform(0, 1, 5).astype(np.float32))


def _same_files(a: Path, b: Path):
    fa = sorted(p.name for p in a.iterdir())
    assert fa == sorted(p.name for p in b.iterdir()) and fa
    for name in fa:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("source", ["gtbox", "precomputed"])
@pytest.mark.parametrize("dataset", ["vod", "tj4d"])
def test_tool_files_equal_jax_tool(trees, tmp_path, monkeypatch, dataset, source):
    tree = trees / dataset
    hw = TREES[dataset]["image_hw"]
    args = ["--dataset", dataset, "--data_root", str(tree), "--image_hw", str(hw[0]), str(hw[1]),
            "--mask_source", source, "--num_virtual", "30", "--seed", "4"]
    if source == "precomputed":
        _write_masks(tree, tmp_path / "masks", hw, seed=9)
        args += ["--masks_dir", str(tmp_path / "masks")]
    monkeypatch.setattr(sys, "argv", ["generate_hybrid_points.py", *args,
                                      "--pts_save_path", str(tmp_path / "jax")])
    _jax_tool().main()
    res = tool.main(args + ["--pts_save_path", str(tmp_path / "port")])
    _same_files(tmp_path / "port", tmp_path / "jax")
    assert res["virtual_total"] > 0
    width = tool._DATASETS[dataset]["radar_dims"] + 8  # xyz, features, 8 one-hot bins
    d = np.load(next((tmp_path / "port").iterdir()), allow_pickle=True).item()
    assert d["virtual_points"].shape[1] == width == d["real_points"].shape[1]


def test_tool_frame_ids_and_calib_equal_jax_tool(trees):
    jt = _jax_tool()
    for name in TREES:
        root = trees / name
        ids = tool.frame_ids(root, "train")
        assert ids == jt.frame_ids(root, "train") and ids
        for a, b in zip(tool.load_calib(root, ids[0]), jt.load_calib(root, ids[0])):
            np.testing.assert_array_equal(a, b)


TINY_ORACLE = dict(embed_dim=32, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=4,
                   hidden_dim=64, num_queries=20, nheads=8, dim_feedforward=128, dec_layers=3,
                   enc_layers=2, num_classes=8)


def _oracle_pkl(path):
    from ref_mask2former import Mask2FormerTorch

    torch.manual_seed(21)
    model = Mask2FormerTorch(**TINY_ORACLE).eval()
    with open(path, "wb") as f:
        pickle.dump({"model": {k: v.numpy() for k, v in model.state_dict().items()},
                     "__author__": "test"}, f)
    return model


def _oracle_instances(model, image01, model_hw, topk=100):
    """The torch oracle with the reference's postprocess: flattened-softmax
    top-k, logits resized to the image, > 0, score = class prob x mean
    in-mask sigmoid. Returns the resized logits of each instance too."""
    mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
    img = torch.from_numpy(image01).permute(2, 0, 1)[None]
    img = F.interpolate(img, size=model_hw, mode="bilinear", align_corners=False)
    with torch.no_grad():
        logits, mask_logits = model((img - mean) / std)
    k = logits.shape[-1] - 1
    scores = logits.softmax(-1)[0, :, :-1].reshape(-1)
    top_scores, top_idx = scores.topk(min(topk, scores.numel()))
    m = F.interpolate(mask_logits, size=image01.shape[:2], mode="bilinear",
                      align_corners=False)[0][top_idx // k]
    binary = m > 0
    denom = binary.sum((1, 2)).clamp(min=1)
    final = top_scores * (torch.sigmoid(m) * binary).sum((1, 2)) / denom * binary.any(2).any(1)
    return (top_idx % k).numpy(), final.numpy(), binary.numpy(), m.numpy()


def test_model_source_with_published_pkl(trees, tmp_path):
    """The tiny preset on the CPU with the oracle's .pkl and
    --resize_shortest: the oracle's masks and labels at a threshold in a
    gap of its scores, and the same files as the precomputed source on the
    port's own masks."""
    tree = trees / "vod"
    hw = TREES["vod"]["image_hw"]
    oracle = _oracle_pkl(tmp_path / "model_final.pkl")
    ids = tool.frame_ids(tree, "train")
    model_hw = (60, 90)  # --resize_shortest 60 on 48 x 72
    ref = {i: _oracle_instances(oracle, tool.read_rgb01(
        tree / f"training/image_2/{i}.jpg"), model_hw) for i in ids}
    pool = np.sort(np.concatenate([r[1][r[1] > 0] for r in ref.values()]))
    gaps = np.diff(pool)
    mid = len(pool) // 2
    j = mid + int(np.argmax(gaps[mid:] > 1e-4))  # the first clear gap above the median
    thresh = float((pool[j] + pool[j + 1]) / 2)

    src = tool.ModelMaskSource("tiny", str(tmp_path / "model_final.pkl"), hw, thresh,
                               resize_shortest=60, device="cpu")
    assert src.model_hw == model_hw
    masks_dir = tmp_path / "port_masks"
    masks_dir.mkdir()
    for i in ids:
        masks, labels = src(tool.read_rgb01(tree / f"training/image_2/{i}.jpg"))
        r_labels, r_scores, r_binary, r_logits = (a[ref[i][1] >= thresh] for a in ref[i])
        # matched as sets: class scores within rounding of each other may
        # take their top-k ranks in either order
        unmatched = list(range(len(r_labels)))
        for m, lab in zip(masks, labels):
            j = next(j for j in unmatched if r_labels[j] == lab
                     and np.all(np.abs(r_logits[j][m != r_binary[j]]) < MASK_LOGIT_TOL))
            unmatched.remove(j)
        assert not unmatched
        np.savez(masks_dir / f"{i}.npz", masks=masks, labels=labels)
    assert sum(len(np.load(masks_dir / f"{i}.npz")["labels"]) for i in ids) > 0

    common = ["--dataset", "vod", "--data_root", str(tree), "--image_hw", str(hw[0]), str(hw[1]),
              "--num_virtual", "30", "--seed", "7", "--confidence_threshold", str(thresh)]
    tool.main(common + ["--mask_source", "model", "--ckpt", str(tmp_path / "model_final.pkl"),
                        "--model_preset", "tiny", "--resize_shortest", "60", "--device", "cpu",
                        "--pts_save_path", str(tmp_path / "model")])
    tool.main(common + ["--mask_source", "precomputed", "--masks_dir", str(masks_dir),
                        "--pts_save_path", str(tmp_path / "precomputed")])
    _same_files(tmp_path / "model", tmp_path / "precomputed")


def test_model_source_pth_and_random_weights(trees, tmp_path):
    """The port's own .pth loads; without --ckpt the weights come from --seed."""
    from hgsfusion_tpu_torch.rhgm.mask2former import Mask2FormerInstance

    m = Mask2FormerInstance(device="cpu", seed=3, **tool.PRESETS["tiny"])
    torch.save(m.state_dict(), tmp_path / "m.pth")
    a = tool.ModelMaskSource("tiny", str(tmp_path / "m.pth"), (48, 72), 0.0, device="cpu")
    b = tool.ModelMaskSource("tiny", None, (48, 72), 0.0, device="cpu", seed=3)
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    img = tool.read_rgb01(trees / "vod/training/image_2/00000.jpg")
    masks, labels = a(img)
    assert masks.shape[1:] == (48, 72) and masks.dtype == bool and len(masks) == len(labels) == 100


def test_model_source_refuses_orbax_directory(trees, tmp_path):
    ckpt = tmp_path / "orbax_ckpt"
    ckpt.mkdir()
    with pytest.raises(ValueError, match="from_jax_mask2former"):
        tool.main(["--data_root", str(trees / "vod"), "--pts_save_path", str(tmp_path / "o"),
                   "--model_preset", "tiny", "--device", "cpu", "--ckpt", str(ckpt)])


def test_model_source_defaults_to_cuda(trees, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--data_root", str(trees / "vod"), "--pts_save_path", str(tmp_path / "o"),
                   "--model_preset", "tiny"])


def test_read_rgb01_matches_pillow(trees):
    from PIL import Image

    for f in (trees / "vod/training/image_2/00000.jpg", next((trees / "tj4d/training/image_2")
                                                             .glob("*.png"))):
        want = np.asarray(Image.open(str(f)).convert("RGB"), np.float32) / 255.0
        np.testing.assert_array_equal(tool.read_rgb01(f), want)
        assert read_image(f).dtype == np.uint8
