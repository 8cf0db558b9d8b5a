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
