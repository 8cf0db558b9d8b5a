"""The optimizers of the OPTIMIZATION block: ``adam_onecycle``, ``adam``
and ``sgd``.

Counterpart of ``hgsfusion_tpu/train/optim.py`` (annealing_cos,
onecycle_lr_schedule, onecycle_mom_schedule, default_frozen_predicate and
build_optimizer). The JAX package builds each from optax, after
clip_by_global_norm(GRAD_NORM_CLIP) and masked so that the frozen DDN
backbone gets no update, no decay and no state:

- ``adam_onecycle``: adamw(b1 = the momentum schedule, b2 0.99, eps 1e-8,
  decoupled weight decay) under inject_hyperparams with the OneCycle LR;
- ``adam``: adamw(LR, weight_decay) with optax's defaults (b1 0.9, b2 0.999,
  eps 1e-8) at a constant LR;
- ``sgd``: add_decayed_weights(WEIGHT_DECAY), then sgd(LR, momentum =
  MOMENTUM or 0.9): a heavy-ball trace, no Nesterov.

``AdamOneCycle`` writes the two AdamW chains out on tensors (the schedules
read at a device-side step counter, so a step reads nothing back to the
host; ``adam``'s constants are Python floats, as optax's), ``SGD`` the
third. ``state_dict`` / ``load_state_dict`` carry the state through a
checkpoint.
"""
from __future__ import annotations

import math

import torch

# the frozen DDN image backbone, in the port's (reference) module names;
# BEVFusion's ddn camera branch keeps the JAX name (the JAX package freezes
# every ``ddn_backbone``)
FROZEN_PREFIX = "fusion_vfe.image_vfe.ffn.ddn.model.backbone."
BEVFUSION_FROZEN_PREFIX = "ddn_backbone."


def annealing_cos(start: float, end: float, pct):
    """Cosine anneal start -> end as pct goes 0 -> 1."""
    cos_out = torch.cos(math.pi * pct) + 1.0
    return end + (start - end) / 2.0 * cos_out


def onecycle_lr_schedule(total_steps: int, lr_max: float, div_factor: float,
                         pct_start: float):
    """lr_max / div_factor -> lr_max over pct_start, then -> that / 1e4."""
    low = lr_max / div_factor
    a1 = int(total_steps * pct_start)

    def schedule(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        up = annealing_cos(low, lr_max, torch.clamp(step / max(a1, 1), 0.0, 1.0))
        down = annealing_cos(lr_max, low / 1e4,
                             torch.clamp((step - a1) / max(total_steps - a1, 1), 0.0, 1.0))
        return torch.where(step < a1, up, down)

    return schedule


def onecycle_mom_schedule(total_steps: int, moms, pct_start: float):
    """beta1: moms[0] -> moms[1] over pct_start, then back."""
    a1 = int(total_steps * pct_start)

    def schedule(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        up = annealing_cos(moms[0], moms[1], torch.clamp(step / max(a1, 1), 0.0, 1.0))
        down = annealing_cos(moms[1], moms[0],
                             torch.clamp((step - a1) / max(total_steps - a1, 1), 0.0, 1.0))
        return torch.where(step < a1, up, down)

    return schedule


def default_frozen_predicate(name: str) -> bool:
    """True for parameters of the frozen DDN image backbone."""
    return name.startswith((FROZEN_PREFIX, BEVFUSION_FROZEN_PREFIX))


class AdamOneCycle:
    """clip_by_global_norm -> AdamW under the OneCycle schedules, on the
    trainable tensors ``params`` (a list), updated in place by ``step``;
    with constant schedules and ``b2`` 0.999, the ``adam`` recipe.

    As optax computes it: the clip scales by max_norm / ||g|| only when
    ||g|| >= max_norm (no epsilon), over the trainable gradients alone; the
    moments use the current beta1, and so does the bias correction; the
    update is -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p). ``count`` is the
    step counter the schedules read (schedule(0) at the first step).
    """

    eps = 1e-8

    def __init__(self, params, lr_schedule, mom_schedule, weight_decay: float,
                 grad_norm_clip: float, b2: float = 0.99):
        self.params = list(params)
        self.b2 = b2  # the adam_onecycle recipe's 0.99; optax's default 0.999 for adam
        self.lr_schedule, self.mom_schedule = lr_schedule, mom_schedule
        self.weight_decay, self.grad_norm_clip = weight_decay, grad_norm_clip
        device = self.params[0].device
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=device)

    @torch.no_grad()
    def step(self, grads):
        """Apply one update from ``grads`` (one per param; None reads as 0)."""
        grads = clip_by_global_norm(self.params, grads, self.grad_norm_clip)
        step_f = self.count.to(torch.float32)
        lr, b1 = self.lr_schedule(step_f), self.mom_schedule(step_f)
        count_inc = self.count + 1
        bc1 = 1 - b1 ** count_inc.to(torch.float32)
        bc2 = 1 - self.b2 ** count_inc.to(torch.float32)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            upd = upd + self.weight_decay * p
            p.add_((-lr) * upd)
        self.count.copy_(count_inc)

    def state_dict(self) -> dict:
        """The moments (one per trainable tensor, in ``params`` order) and
        the step counter, as tensors on the optimizer's device."""
        return {"mu": list(self.mu), "nu": list(self.nu), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        """Copy a ``state_dict()`` in place: the OneCycle schedules go on
        from its ``count``. Its moments must match ``params`` in number and
        shape."""
        _copy_state(self, state, ("mu", "nu"))
        self.count.copy_(torch.as_tensor(state["count"]))


class SGD:
    """clip_by_global_norm -> add_decayed_weights -> SGD with momentum, on
    the trainable tensors ``params``, updated in place by ``step``: as optax
    computes it, u = g + wd p, trace = u + momentum trace (0 at the start),
    p -= lr trace."""

    def __init__(self, params, lr: float, momentum: float, weight_decay: float,
                 grad_norm_clip: float):
        self.params = list(params)
        self.lr, self.momentum = lr, momentum
        self.weight_decay, self.grad_norm_clip = weight_decay, grad_norm_clip
        self.trace = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        """Apply one update from ``grads`` (one per param; None reads as 0)."""
        grads = clip_by_global_norm(self.params, grads, self.grad_norm_clip)
        for p, g, tr in zip(self.params, grads, self.trace):
            tr.copy_((g + self.weight_decay * p) + self.momentum * tr)
            p.add_(-self.lr * tr)

    def state_dict(self) -> dict:
        """The momentum traces, one per trainable tensor in ``params`` order."""
        return {"trace": list(self.trace)}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        """Copy a ``state_dict()`` in place; its traces must match ``params``
        in number and shape."""
        _copy_state(self, state, ("trace",))


def clip_by_global_norm(params, grads, max_norm: float):
    """optax.clip_by_global_norm over the trainable gradients (None reads as
    0): scaled by max_norm / ||g|| only when ||g|| >= max_norm, no epsilon."""
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = g_norm < max_norm
    return [torch.where(keep, g, g / g_norm * max_norm) for g in grads]


def _copy_state(opt, state: dict, keys):
    for key in keys:
        if len(state[key]) != len(opt.params):
            raise ValueError(f"optimizer state has {len(state[key])} {key} tensors, "
                             f"the optimizer {len(opt.params)}")
        for mine, saved in zip(getattr(opt, key), state[key]):
            if mine.shape != saved.shape:
                raise ValueError(f"optimizer state {key}: shape {tuple(saved.shape)}, "
                                 f"want {tuple(mine.shape)}")
            mine.copy_(saved)


def build_optimizer(optim_cfg, total_steps: int, model):
    """The ``OPTIMIZER`` recipe of ``optim_cfg`` (OPTIMIZATION keys) over
    ``model``'s parameters: ``adam_onecycle``, ``adam`` or ``sgd``. Frozen
    parameters get ``requires_grad_(False)`` and no optimizer state. Returns
    (optimizer, lr_schedule)."""
    name = optim_cfg.get("OPTIMIZER", "adam_onecycle")
    if name not in ("adam_onecycle", "adam", "sgd"):
        raise NotImplementedError(name)
    lr = float(optim_cfg["LR"])
    wd = float(optim_cfg.get("WEIGHT_DECAY", 0.0))
    clip = float(optim_cfg.get("GRAD_NORM_CLIP", 10.0))
    trainable = []
    for pname, p in model.named_parameters():
        frozen = default_frozen_predicate(pname)
        p.requires_grad_(not frozen)
        if not frozen:
            trainable.append(p)
    if name == "sgd":
        return SGD(trainable, lr, float(optim_cfg.get("MOMENTUM", 0.9)), wd, clip), \
            lambda step: lr
    if name == "adam":
        # optax.adamw(lr, weight_decay=wd): b1 0.9, b2 0.999, a constant LR
        return AdamOneCycle(trainable, lambda step: lr, lambda step: 0.9, wd, clip,
                            b2=0.999), lambda step: lr
    lr_schedule = onecycle_lr_schedule(total_steps, lr, float(optim_cfg["DIV_FACTOR"]),
                                       float(optim_cfg["PCT_START"]))
    mom_schedule = onecycle_mom_schedule(total_steps, [float(m) for m in optim_cfg["MOMS"]],
                                         float(optim_cfg["PCT_START"]))
    return AdamOneCycle(trainable, lr_schedule, mom_schedule, wd, clip), lr_schedule
