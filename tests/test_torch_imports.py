"""The PyTorch port imports neither JAX nor the JAX package."""
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_GUARD = r"""
EXTRA = tuple(__import__("sys").argv[1:])
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "hgsfusion_tpu") + EXTRA

def forbidden(name):
    return name.split(".")[0] in FORBIDDEN

for name in [k for k in sys.modules if forbidden(k)]:
    del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if forbidden(name):
            raise ImportError("the port imported " + name)
        return None

sys.meta_path.insert(0, Block())
import hgsfusion_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(hgsfusion_tpu_torch.__path__, "hgsfusion_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(k for k in sys.modules if forbidden(k))
assert not bad, bad
print(" ".join(mods))
"""


NEW_SUBMODULES = {
    "hgsfusion_tpu_torch.datasets", "hgsfusion_tpu_torch.datasets.dataset",
    "hgsfusion_tpu_torch.datasets.image_io", "hgsfusion_tpu_torch.datasets.kitti_base",
    "hgsfusion_tpu_torch.datasets.processor", "hgsfusion_tpu_torch.datasets.synthetic",
    "hgsfusion_tpu_torch.datasets.vod", "hgsfusion_tpu_torch.eval",
    "hgsfusion_tpu_torch.eval.kitti_ap", "hgsfusion_tpu_torch.eval.rotated_iou_np",
    "hgsfusion_tpu_torch.eval.vod_eval", "hgsfusion_tpu_torch.ops.points_in_boxes",
    "hgsfusion_tpu_torch.tools", "hgsfusion_tpu_torch.tools.create_infos",
    "hgsfusion_tpu_torch.tools.test", "hgsfusion_tpu_torch.utils.calibration",
    "hgsfusion_tpu_torch.datasets.augmentor", "hgsfusion_tpu_torch.datasets.loader",
    "hgsfusion_tpu_torch.train.checkpoint", "hgsfusion_tpu_torch.tools.train",
    "hgsfusion_tpu_torch.models.swin", "hgsfusion_tpu_torch.rhgm",
    "hgsfusion_tpu_torch.rhgm.mask2former", "hgsfusion_tpu_torch.rhgm.generator",
    "hgsfusion_tpu_torch.rhgm.checkpoint", "hgsfusion_tpu_torch.tools.generate_hybrid_points",
    "hgsfusion_tpu_torch.ops.library", "hgsfusion_tpu_torch.ops.matmul",
    "hgsfusion_tpu_torch.tools.export", "hgsfusion_tpu_torch.tools.serve",
    "hgsfusion_tpu_torch.bench", "hgsfusion_tpu_torch.parallel",
    "hgsfusion_tpu_torch.parallel.mesh", "hgsfusion_tpu_torch.parallel.multihost",
    "hgsfusion_tpu_torch.parallel.spawn",
    "hgsfusion_tpu_torch.eval.tta", "hgsfusion_tpu_torch.tools.test_tta",
    "hgsfusion_tpu_torch.tools.make_study_data", "hgsfusion_tpu_torch.tools.study_polar_match",
    "hgsfusion_tpu_torch.ops.depth_sample", "hgsfusion_tpu_torch.models.ddn_loss",
    "hgsfusion_tpu_torch.ops.conv_int8", "hgsfusion_tpu_torch.ops.deform_conv",
    "hgsfusion_tpu_torch.models.registry", "hgsfusion_tpu_torch.models.base_bev_backbone",
    "hgsfusion_tpu_torch.utils.visual", "hgsfusion_tpu_torch.utils.visual_3d",
    "hgsfusion_tpu_torch.tools.demo", "hgsfusion_tpu_torch.models.focal_conv",
    "hgsfusion_tpu_torch.models.pvrcnn", "hgsfusion_tpu_torch.models.roi_heads",
    "hgsfusion_tpu_torch.ops.pointnet2", "hgsfusion_tpu_torch.models.parta2",
    "hgsfusion_tpu_torch.ops.roiaware_pool",
}


def _walk(*blocked):
    proc = subprocess.run([sys.executable, "-c", _GUARD, *blocked], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return set(proc.stdout.split())


def test_port_imports_no_jax():
    mods = _walk()
    assert len(mods) >= 51  # every submodule was imported
    assert {"hgsfusion_tpu_torch.train.optim", "hgsfusion_tpu_torch.train.trainer",
            "hgsfusion_tpu_torch.train.step_compare",
            "hgsfusion_tpu_torch.models.polar_f2v"} <= mods
    assert NEW_SUBMODULES <= mods


def test_port_imports_without_pillow_and_yaml():
    """Pillow and PyYAML are imported only where a JPEG is read or a YAML
    loaded."""
    assert NEW_SUBMODULES <= _walk("PIL", "yaml")


def test_port_imports_without_matplotlib_and_scipy():
    """matplotlib (the demo's PNGs) and scipy (``imgaug``'s rotation) are
    imported only where a figure is drawn or an image rotated."""
    assert NEW_SUBMODULES <= _walk("matplotlib", "scipy")


# the serving host's import contract: torch, the ops and their loader, no
# model code; the ops' CPU implementations (the plain versions) included
_SERVING_HOST = r"""
import importlib.abc, sys
BLOCKED = ("jax", "hgsfusion_tpu", "hgsfusion_tpu_torch.models", "hgsfusion_tpu_torch.config",
           "hgsfusion_tpu_torch.datasets", "hgsfusion_tpu_torch.train", "yaml", "PIL")

def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("the serving host imported " + name)
sys.meta_path.insert(0, Block())
import torch
from hgsfusion_tpu_torch.tools import serve
from hgsfusion_tpu_torch.ops import library
feats, uv = torch.rand(1, 4, 5, 8), torch.rand(1, 3, 2) * 2 - 1
assert library.quad_sample_op(feats, uv).shape == (3, 8)
kmat, bias = torch.rand(8, 4), torch.rand(4)
assert library.quad_sample_reduce_op(uv, [feats], [0], kmat, bias).shape == (3, 4)
boxes = torch.tensor([[[0, 0, 0, 2, 1, 1, 0], [0.1, 0, 0, 2, 1, 1, 0.1], [5, 5, 0, 1, 1, 1, 0]]])
probs, grid = torch.rand(1, 4, 5, 6), torch.rand(1, 3, 3) * 2 - 1
assert library.quad_sample_depth_op(feats, probs, grid).shape == (3, 8)
keep = library.nms_lazy_op(boxes, torch.ones(1, 3, dtype=torch.bool), 0.1, 10)
assert keep.tolist() == [[True, False, True]], keep
pts = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [3, 0, 0], [2, 0, 0]]])
idx = library.farthest_point_sample_op(pts, torch.ones(1, 4, dtype=torch.bool), 3)
assert idx.tolist() == [[0, 2, 1]], idx
print(" ".join(sorted(k for k in sys.modules if k.startswith("hgsfusion_tpu_torch"))))
"""


def test_serving_host_imports_no_model_code():
    """``tools/serve.py`` and ``ops/library.py`` (and the plain versions the
    ops take on the CPU) import no model code, config, dataset, training,
    YAML or image module."""
    proc = subprocess.run([sys.executable, "-c", _SERVING_HOST], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    mods = set(proc.stdout.split())
    assert {"hgsfusion_tpu_torch.ops.library", "hgsfusion_tpu_torch.tools.serve",
            "hgsfusion_tpu_torch.native", "hgsfusion_tpu_torch.ops.nms",
            "hgsfusion_tpu_torch.ops.quad_sample", "hgsfusion_tpu_torch.ops.depth_sample",
            "hgsfusion_tpu_torch.ops.pointnet2"} <= mods
    assert not any(m.startswith("hgsfusion_tpu_torch.models") for m in mods)
