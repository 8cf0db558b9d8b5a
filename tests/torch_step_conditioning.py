"""How well conditioned the TINY training step of tests/test_torch_train.py is.

    JAX_PLATFORMS=cpu python tests/torch_step_conditioning.py [--threads N]

Prints, for the JAX init of the test (randomized BN statistics and affine
parameters), with the frozen backbone's residual scales as initialized and
at 0:

- the port's train-mode BatchNorms: the largest gap between flax's fast
  variance E[x^2] - E[x]^2 and the two-pass variance, relative to var + eps,
  over every channel (cancellation would show here);
- the port's sensitivity (``step_compare.sensitivity``) at input
  perturbations of 1e-7 and 1e-6, and the JAX-vs-port gradient gap of the
  first step, each as a fraction of the tensor's largest gradient, for the
  worst tensor;
- along JAX's trajectory (each port step from JAX's state before it), the
  worst JAX-vs-port gap of each of three steps.
"""
import argparse
import functools
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import test_torch_train as T  # noqa: E402
from hgsfusion_tpu_torch.models import (bev_encoder, frustum, fusion_bev, layers,  # noqa: E402
                                        occupancy, resnet)
from hgsfusion_tpu_torch.train import step_compare  # noqa: E402
from test_model import ANCHOR_CFG, TINY, make_tiny_batch  # noqa: E402
from test_train import LOSS_WEIGHTS, OPTIM_CFG  # noqa: E402

_BN_GAPS = []


def _recording_batch_norm(x, bn, dtype=None, dim=-1):
    if bn.training:
        d = dim % x.dim()
        axes = [a for a in range(x.dim()) if a != d]
        xd = x.detach().double()
        mean = xd.mean(axes)
        shape = [1] * x.dim()
        shape[d] = -1
        exact = ((xd - mean.view(shape)) ** 2).mean(axes)
        xf = x.detach().float()
        m = xf.mean(axes)
        fast = torch.clamp((xf * xf).mean(axes) - m * m, min=0.0).double()
        _BN_GAPS.append(float(((fast - exact).abs() / (exact + bn.eps)).max()))
    return _ORIGINAL(x, bn, dtype, dim)


_ORIGINAL = layers.batch_norm


def _worst(ref, other, names):
    """(fraction of the tensor's largest gradient, tensor) of the largest
    gap, over tensors with a gradient above step_compare.ZERO_FLOOR."""
    big = max(float(ref[k].abs().max()) for k in names)
    rows = [(float((other[k] - ref[k]).abs().max()) / float(ref[k].abs().max()), k)
            for k in names if float(ref[k].abs().max()) > step_compare.ZERO_FLOOR * big]
    return max(rows)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=1)
    torch.set_num_threads(ap.parse_args().threads)
    for mod in (layers, resnet, frustum, bev_encoder, occupancy, fusion_bev):
        mod.batch_norm = _recording_batch_norm
    batch = make_tiny_batch(np.random.RandomState(0))
    jmodel = T.JaxModel(cfg=T.TINY_PALLAS)
    init = T.perturb_variables(
        jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, False))(batch), seed=1)
    tx, _ = T.jax_build_optimizer(OPTIM_CFG, total_steps=T.TOTAL_STEPS, params=init["params"])
    tx = optax.chain(T._capture(), tx)
    assigner = T.JaxAssigner(ANCHOR_CFG, TINY.grid_size, TINY.pc_range,
                             class_names=TINY.class_names)
    jstep = jax.jit(T.jax_make_train_step(jmodel, assigner, tx, LOSS_WEIGHTS, T.TINY_PALLAS))
    for label, variables in (("residual scales as initialized", init),
                             ("residual scales at 0", T._zero_residual_scales(init))):
        state = T.TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                             opt_state=tx.init(variables["params"]),
                             step=np.zeros((), np.int32))
        _BN_GAPS.clear()
        got = T._port_step(state, batch)[0]
        bn_gap = max(_BN_GAPS)
        names = list(got["grads"])
        print(f"{label}:")
        print(f"  BN fast vs two-pass variance: largest gap {bn_gap:.3g} of var + eps")
        for rel in (1e-7, 1e-6):
            T.perturb_inputs = functools.partial(step_compare.perturb_inputs, rel=rel)
            probes = [T._port_step(state, batch, seed)[0]["grads"] for seed in (1, 2)]
            worst = max(_worst(got["grads"], p, names) for p in probes)
            print(f"  sensitivity at {rel:g}: {worst[0]:.3g} of the max of {worst[1]}")
        gaps = []
        for i in range(3):
            got = T._port_step(state, batch)[0] if i else got
            state, tb = jstep(state, batch)
            ref = T._jax_record(state, tb, names)
            gaps.append(_worst(ref["grads"], got["grads"], names))
        for i, (gap, k) in enumerate(gaps):
            print(f"  JAX vs port, step {i + 1} from JAX's state: {gap:.3g} of the max of {k}")


if __name__ == "__main__":
    main()
