"""The f32-accumulating product of the view transforms' reduce
(``einsum(..., preferred_element_type=float32)`` in the JAX package).

It lives under ``ops/`` so that ``ops/library.py``, which a serving host
imports without the model code, reaches the fused sampler's plain version
through it."""
from __future__ import annotations

import torch


class _MatmulF32(torch.autograd.Function):
    """a @ b of two half-precision CUDA matrices (or batches of them),
    accumulated and returned in f32 by one ``torch.mm`` / ``torch.bmm`` with
    ``out_dtype=float32``; its gradients are f32 products rounded once to
    the operands' dtypes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mixed_product(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = (g @ b.float().mT).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = (a.float().mT @ g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def _mixed_product(a, b):
    return (torch.mm if a.dim() == 2 else torch.bmm)(a, b, out_dtype=torch.float32)


def matmul_f32(a, b):
    """(N, K) @ (K, O), or (B, N, K) @ (B, K, O), -> f32, never rounded to a
    narrower type: the ``einsum(..., preferred_element_type=float32)`` of
    the JAX package. A bf16/f16 pair on CUDA takes one mixed-precision
    product (through ``_MatmulF32`` only where a gradient is taken, so that
    ``torch.export`` of a served frame sees the product itself); elsewhere
    the operands are upcast (the CPU has no such product)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) and b.dtype == a.dtype:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _MatmulF32.apply(a, b)
        return _mixed_product(a, b)
    return a.to(torch.float32) @ b.to(torch.float32)
