"""Where the port's TINY TJ4D B=2 training step is ill-conditioned: the ReLUs
after ``pred_occupancy.1`` (the occupancy head's first BatchNorm) that a
``step_compare`` probe flips.

    JAX_PLATFORMS=cpu python -m pytest tests/torch_relu_flip.py -q -s

Not a Tier-1 test (the name does not match ``test_*.py``): a measurement
run on demand. For the augmentation draws of ``TRAIN_SEED`` 6 and 5 of
tests/test_torch_tj4d.py, the port's step from JAX's init is run once as
it is and once under each of two 1e-7 input probes
(``step_compare.perturb_inputs``). Printed per probe: the largest change of
``pred_occupancy.1.bias``'s gradient over its largest value, its channel,
how many of that BatchNorm's outputs changed sign (a ReLU flipped) in that
channel and in all, and the pre-activation of a flipped output over its
channel's std.
"""
import numpy as np
import torch

from hgsfusion_tpu_torch.models import occupancy
from hgsfusion_tpu_torch.train.step_compare import GradCapture, perturb_inputs, step_record
from test_torch_tj4d import (CLASSES, TOTAL_STEPS, HGSFusionModel, TargetAssigner,  # noqa: F401
                             _zero_residual_scales, build_dataset, build_optimizer,
                             device_batch, from_jax_variables, load, make_train_step,
                             model_config_from_yaml, tiny, tree)

BIAS = "fusion_vfe.radar_occupancy.pred_occupancy.1.bias"


def _step(pcfg, variables, batch, perturb_seed=None):
    """The port's step record and pred_occupancy.1's train-mode output
    (before its ReLU)."""
    model = load(HGSFusionModel(pcfg, device="cpu"), from_jax_variables(variables))
    opt, _ = build_optimizer(pcfg.optimization, TOTAL_STEPS, model)
    cap = GradCapture(opt)
    assigner = TargetAssigner(pcfg.anchor_generator, pcfg.grid_size, pcfg.pc_range,
                              pcfg.class_names, device="cpu")
    step = make_train_step(model, assigner, cap, pcfg.loss_weights, pcfg)
    b = model.batch_to_device(batch)
    if perturb_seed is not None:
        b = perturb_inputs(b, perturb_seed)
    bn = model.fusion_vfe.radar_occupancy.pred_occupancy[1]
    seen = []
    plain = occupancy.batch_norm

    def batch_norm(x, m, *a, **k):
        y = plain(x, m, *a, **k)
        if m is bn:
            seen.append(y.detach().clone())
        return y

    occupancy.batch_norm = batch_norm
    try:
        _, tb = step(b)
    finally:
        occupancy.batch_norm = plain
    return step_record(model, cap, tb), seen[0]


def test_probe_flips(tiny):
    pcfg = model_config_from_yaml(tiny["pcfg"])
    train_ds = build_dataset(tiny["pcfg"]["DATA_CONFIG"], CLASSES, training=True)
    variables = _zero_residual_scales(tiny["variables"])
    for seed in (6, 5):
        np.random.seed(seed)
        batch = device_batch(train_ds.collate_batch([train_ds[i] for i in range(2)]))
        ref, y = _step(pcfg, variables, batch)
        g = ref["grads"][BIAS]
        y = y.reshape(-1, y.shape[-1])
        print(f"\nseed {seed}: {y.shape[0]} positions x {y.shape[1]} channels")
        for probe in (1, 2):
            rec, yp = _step(pcfg, variables, batch, probe)
            yp = yp.reshape(y.shape)
            d = (rec["grads"][BIAS] - g).abs()
            c = int(d.argmax())
            flipped = (y > 0) != (yp > 0)
            at = [float(y[i, c].abs() / y[:, c].std()) for i in
                  torch.nonzero(flipped[:, c]).flatten().tolist()]
            print(f"  probe {probe}: change {float(d.max() / g.abs().max()):.3g} of the largest, "
                  f"channel {c}; flips in it {int(flipped[:, c].sum())}, in all "
                  f"{int(flipped.sum())}; |pre-activation| / std at the flips {at}")
