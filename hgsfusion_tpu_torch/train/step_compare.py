"""Holding one training step to another run of the same step.

Two runs of one step from the same state (the port against the JAX package
in ``tests/test_torch_train.py``; the card against the CPU in
``chip_smoke.py``) are compared in four things: the loss terms, the
gradients, the updated parameters and the BN running statistics.

The gradient tolerance is measured, and capped. ``sensitivity`` is how far
one side's own gradient moves when its images and points are moved by about
one f32 rounding (``PERTURB``, relative): the size of the difference that
another order of the same arithmetic makes. A tensor whose sensitivity
exceeds ``SENS_CAP`` of its largest gradient fails the comparison, because
there the step is too ill-conditioned to tell a wrong gradient from a
rounding; so no tensor's tolerance exceeds (GRAD_RTOL + SENS x SENS_CAP) =
5e-3 of its largest gradient.

Two things make a training step ill-conditioned at a small test size, and
the callers avoid both: a train-mode ResNet with random weights amplifies a
change of its input by orders of magnitude by its last stage (the callers
zero its residual scales, ``zero_residual_scales``), and a 1e-6 input
change flips ReLU inputs near 0 at the few positions where the loss
gradient concentrates (``PERTURB`` is 1e-7). What remains are switches of
single ReLUs where the gradient is spread, which move a tensor's gradient by
up to about 1e-4 of its largest (``GRAD_RTOL`` is 1e-3).

Imports nothing of JAX.
"""
from __future__ import annotations

import torch

from .optim import FROZEN_PREFIX

LOSS_RTOL = 1e-4  # f32 sums over up to a few thousand anchors in another order
# gradients, per tensor with largest reference gradient m:
# |d| <= GRAD_RTOL m + SENS s, with s <= SENS_CAP m required
GRAD_RTOL, SENS, SENS_CAP = 1e-3, 4.0, 1e-3
# a tensor with m <= ZERO_FLOOR G (G: the largest m of any tensor) has a true
# gradient of 0, as a bias in front of a train-mode BN has: both sides return
# rounding noise, held to |g| <= ZERO_FLOOR G
ZERO_FLOOR = 1e-6
PERTURB = 1e-7
# updated parameters: where the gradients of an element differ by at most
# the tolerance t, Adam's updates differ by at most about ADAM_SLACK lr t/|g|
# (lr t / |g| at the first step, more with the moments of later ones), and
# by 2 lr once the sign is open; so |d| <= PARAM_ATOL + PARAM_RTOL |p| +
# lr min(2, ADAM_SLACK t / |g_ref|), and no slack where both gradients are 0
PARAM_RTOL, PARAM_ATOL, ADAM_SLACK = 1e-5, 1e-6, 4.0
STATS_RTOL, STATS_ATOL = 1e-4, 1e-5


class GradCapture:
    """Optimizer wrapper that keeps a copy of the gradients it is given."""

    def __init__(self, opt):
        self.opt, self.params, self.grads = opt, opt.params, None

    def step(self, grads):
        self.grads = [None if g is None else g.detach().clone() for g in grads]
        self.opt.step(grads)


def zero_residual_scales(model):
    """Zero the scale of the last BN of every bottleneck of the frozen image
    backbone, so each block starts as its shortcut (the "zero-init
    residual" of Goyal et al., 2017). The blocks' BN statistics still
    update in train mode."""
    n = 0
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.startswith(FROZEN_PREFIX) and name.endswith(".bn3"):
                m.weight.zero_()
                n += 1
    if n == 0:
        raise ValueError("the model has no backbone bottleneck")
    return model


def perturb_inputs(batch, seed: int, rel: float = PERTURB):
    """``batch`` with its images (where it has them) and points scaled by
    1 + rel N(0, 1); uint8 images (a dataset's) first become the f32 images
    the model reads them as, x / 255."""
    g = torch.Generator().manual_seed(seed)
    out = dict(batch)
    for k in ("images", "points"):
        if k not in batch:  # a radar- or lidar-only batch has no images
            continue
        x = batch[k]
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / 255.0
        noise = torch.randn(x.shape, generator=g).to(x.device)
        out[k] = x * (1 + rel * noise)
    return out


def step_record(model, capture: GradCapture, tb):
    """The loss terms, the captured gradients (a None gradient reads 0), the
    updated trainable parameters and the BN running statistics, on the
    host, by the port's parameter names."""
    params = dict(model.named_parameters())
    names = [k for k, p in params.items() if p.requires_grad]
    return {
        "tb": {k: v.detach().cpu() for k, v in tb.items()},
        "grads": {k: (torch.zeros_like(params[k]) if g is None else g).cpu()
                  for k, g in zip(names, capture.grads)},
        "params": {k: params[k].detach().cpu().clone() for k in names},
        "stats": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
                  if k.endswith(("running_mean", "running_var"))},
    }


def sensitivity(grads, probes):
    """Per tensor, the largest change of ``grads`` over the probes' (the
    same step's gradients on perturbed inputs)."""
    return {k: max(float((p[k] - g).abs().max()) for p in probes) for k, g in grads.items()}


def over_cap(grads, sens):
    """The tensors whose sensitivity exceeds ``SENS_CAP`` of their largest
    gradient (those under ``ZERO_FLOOR`` of the largest of all left out)."""
    big_g = max(float(g.abs().max()) for g in grads.values())
    return sorted(k for k, g in grads.items() if float(g.abs().max()) > ZERO_FLOOR * big_g
                  and sens[k] > SENS_CAP * float(g.abs().max()))


def compare_steps(ref, got, sens, lr: float, exempt=()):
    """Hold ``got`` to ``ref`` (``step_record``s of one step from one state)
    under the tolerances above; ``sens``: the sensitivity of each tensor,
    ``lr``: the step's learning rate. ``exempt`` names tensors (``over_cap``)
    whose gradients and updated values are not compared, where a step is
    ill-conditioned in some tensors only; every other tensor is. Raises
    AssertionError; returns a report of the margins."""
    report = {"zero_tensors": 0, "exempt": 0, "excluded": 0, "elements": 0, "loss_rel_err": 0.0,
              "grad_err_over_tol": 0.0, "tol_over_max": 0.0, "sens_over_max": 0.0,
              "param_err_over_tol": 0.0}
    assert set(got["tb"]) == set(ref["tb"]), (sorted(got["tb"]), sorted(ref["tb"]))
    for k, v in ref["tb"].items():
        err = float((got["tb"][k] - v).abs())
        if not err <= LOSS_RTOL * float(v.abs()):
            raise AssertionError(f"loss term {k}: {float(got['tb'][k])} vs {float(v)}")
        report["loss_rel_err"] = max(report["loss_rel_err"], err / max(float(v.abs()), 1e-30))
    big_g = max(float(g.abs().max()) for g in ref["grads"].values())
    for k, g_ref in ref["grads"].items():
        if k in exempt:
            report["exempt"] += 1
            continue
        g_got = got["grads"][k]
        top = float(g_ref.abs().max())
        err = float((g_got - g_ref).abs().max())
        if top <= ZERO_FLOOR * big_g:
            tol = ZERO_FLOOR * big_g
            report["zero_tensors"] += 1
            if not float(g_got.abs().max()) <= tol:
                raise AssertionError(f"gradient {k}: {float(g_got.abs().max())} where the "
                                     f"reference is at most {top}")
        else:
            if not sens[k] <= SENS_CAP * top:
                raise AssertionError(
                    f"gradient {k}: ill-conditioned step, sensitivity {sens[k]} is "
                    f"{sens[k] / top:.3g} of the largest gradient (cap {SENS_CAP})")
            tol = GRAD_RTOL * top + SENS * sens[k]
            if not err <= tol:
                raise AssertionError(f"gradient {k}: max error {err} > {tol}")
            report["grad_err_over_tol"] = max(report["grad_err_over_tol"], err / tol)
            report["tol_over_max"] = max(report["tol_over_max"], tol / top)
            report["sens_over_max"] = max(report["sens_over_max"], sens[k] / top)
        p_ref, p_got = ref["params"][k], got["params"][k]
        slack = lr * torch.clamp(ADAM_SLACK * tol / g_ref.abs(), max=2.0)
        slack = torch.where((g_ref == 0) & (g_got == 0), 0.0, slack)
        report["excluded"] += int((slack >= 2 * lr).sum())
        report["elements"] += slack.numel()
        over = (p_got - p_ref).abs() / (PARAM_ATOL + PARAM_RTOL * p_ref.abs() + slack)
        report["param_err_over_tol"] = max(report["param_err_over_tol"], float(over.max()))
        if not float(over.max()) <= 1.0:
            i = int(over.argmax())
            raise AssertionError(f"updated {k}: element {i} off by "
                                 f"{float((p_got - p_ref).abs().flatten()[i])}, "
                                 f"{float(over.flatten()[i]):.3g} x its tolerance")
    for k, v in ref["stats"].items():
        torch.testing.assert_close(got["stats"][k], v, rtol=STATS_RTOL, atol=STATS_ATOL,
                                   msg=lambda m, k=k: f"{k}: {m}")
    return report
