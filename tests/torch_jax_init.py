"""The JAX package's init of a full-width config as the port's state_dict,
and how its draw compares with the port's own init.

    JAX_PLATFORMS=cpu python tests/torch_jax_init.py \\
        [--cfg_file configs/hgsfusion_vod.yaml] [--out output/jax_vod_init.pt]

Draws the variables as the JAX package's ``tools/train.py`` does
(``model.init(PRNGKey(0), batch, False)``), converts them with
``weights.from_jax_variables`` and, with ``--out``, writes them in fp16 for
``chip_smoke.first_step_terms`` on the card. flax draws each parameter from
the key folded with its module path, so the values depend on the widths
alone: the init is traced at the config's widths and z levels on a small
x/y range and image (``--check_shapes`` draws it at two such cuts and
checks that they agree).

Prints, per tensor of the port's ``HGSFusionModel(seed=0)`` (the weights of
a ``tools/train.py`` run that loads none), the std and mean of JAX's draw
against the port's, the tensors whose std differs by more than 4 standard
errors (or whose constants differ) first.
"""
import argparse
import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from hgsfusion_tpu.config import load_config as jax_load_config  # noqa: E402
from hgsfusion_tpu.config import model_config_from_yaml as jax_model_config  # noqa: E402
from hgsfusion_tpu.models.detector import HGSFusionModel as JaxModel  # noqa: E402
from hgsfusion_tpu_torch.config import load_config, model_config_from_yaml  # noqa: E402
from hgsfusion_tpu_torch.models.detector import HGSFusionModel  # noqa: E402
from hgsfusion_tpu_torch.weights import from_jax_variables  # noqa: E402
from test_model import make_tiny_batch  # noqa: E402
from torch_parity import to_numpy_tree  # noqa: E402


def jax_init(cfg_file: str, half_xy: float = 2.56):
    """The JAX package's variables of ``cfg_file`` from PRNGKey(0), traced on
    an x/y range of +-``half_xy`` m and a 64x96 image."""
    cfg = jax_model_config(jax_load_config(cfg_file))
    lo = cfg.pc_range
    cut = dataclasses.replace(
        cfg, pc_range=(lo[0], -half_xy, lo[2], lo[0] + 2 * half_xy, half_xy, lo[5]),
        image_size=(64, 96), compute_dtype="float32")
    batch = make_tiny_batch(np.random.RandomState(0))
    model = JaxModel(cfg=cut)
    return to_numpy_tree(jax.jit(lambda b: model.init(jax.random.PRNGKey(0), b, False))(batch))


def compare(jax_sd, port_sd):
    """Per tensor: (name, n, JAX std / port std, JAX mean, port mean, off)."""
    rows = []
    for k, p in port_sd.items():
        if not torch.is_floating_point(p):
            continue
        j = jax_sd[k].double()
        p = p.double()
        n = p.numel()
        sj, sp = float(j.std()) if n > 1 else 0.0, float(p.std()) if n > 1 else 0.0
        if sp == 0.0 or sj == 0.0:
            ratio = 1.0 if sp == sj else float("inf")
            off = not torch.equal(j, p)
        else:
            ratio = sj / sp
            off = abs(ratio - 1.0) > 4.0 / np.sqrt(2.0 * n)
        rows.append((k, n, ratio, float(j.mean()), float(p.mean()), off))
    return sorted(rows, key=lambda r: (not r[5], -abs(np.log(max(r[2], 1e-30)))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg_file", default="configs/hgsfusion_vod.yaml")
    ap.add_argument("--out")
    ap.add_argument("--check_shapes", action="store_true")
    args = ap.parse_args(argv)
    variables = jax_init(args.cfg_file)
    if args.check_shapes:
        other = jax_init(args.cfg_file, half_xy=1.28)
        same = jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, variables, other))
        print(json.dumps({"draw_independent_of_the_cut": bool(same)}))
    jax_sd = from_jax_variables(variables)
    port = HGSFusionModel(model_config_from_yaml(load_config(args.cfg_file)), device="cpu",
                          seed=0)
    port_sd = port.state_dict()
    missing = sorted(set(port_sd) ^ set(jax_sd))
    if missing:
        raise SystemExit(f"the two state_dicts differ in keys: {missing[:10]}")
    rows = compare(jax_sd, port_sd)
    n_off = int(sum(r[5] for r in rows))
    print(json.dumps({"tensors": len(rows), "off": n_off,
                      "elements": sum(r[1] for r in rows)}))
    for k, n, ratio, mj, mp, off in rows[:max(n_off, 10)]:
        print(f"  {'OFF' if off else 'ok '} {k} n={n} std jax/port {ratio:.4f} "
              f"mean jax {mj:.4g} port {mp:.4g}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.half() if torch.is_floating_point(v) else v
                    for k, v in jax_sd.items()}, args.out)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
