"""The PyTorch port imports neither JAX nor the JAX package."""
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_GUARD = r"""
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "hgsfusion_tpu")

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


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    mods = proc.stdout.split()
    assert len(mods) >= 22  # every submodule was imported
    assert {"hgsfusion_tpu_torch.train.optim", "hgsfusion_tpu_torch.train.trainer",
            "hgsfusion_tpu_torch.train.step_compare"} <= set(mods)
