"""Swin Transformer image backbone, NHWC at its boundaries: the parts that
Mask2Former uses (counterpart of ``hgsfusion_tpu/models/swin.py``).

Parameter names are the published Mask2Former swin backbone's (microsoft
Swin-Transformer under detectron2): ``patch_embed.{proj, norm}``,
``layers.{i}.blocks.{j}.{norm1, attn.{qkv, proj,
relative_position_bias_table, relative_position_index}, norm2,
mlp.{fc1, fc2}}``, ``layers.{i}.downsample.{norm, reduction}`` and
``norm{i}``, so a published ``state_dict`` loads as it is.
``relative_position_index`` is a persistent buffer, as in the published
dict; the shifted-window masks are built once per padded size and kept out
of the ``state_dict``.

Two layouts differ from the JAX package, which mirrors mmcv:
``PatchMerging`` concatenates its 2x2 neighbours position-major
([x(0::2, 0::2), x(1::2, 0::2), x(0::2, 1::2), x(1::2, 1::2)], index
pos * C + c), and ``SwinBlock.attn`` holds the window attention's
parameters itself (the JAX ``ShiftWindowMSA`` nests them in ``w_msa``).
``weights.from_jax_mask2former`` converts. Attention is plain batched
products and a softmax in f32, as the JAX package computes it in XLA.
Inference only: no stochastic depth.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import conv_nhwc


def _rel_position_index(wh: int, ww: int) -> np.ndarray:
    """Relative-position index of WindowMSA, (wh*ww, wh*ww) int64."""
    seq1 = np.arange(0, (2 * ww - 1) * wh, 2 * ww - 1)
    seq2 = np.arange(0, ww)
    coords = (seq1[:, None] + seq2[None, :]).reshape(1, -1)
    idx = coords + coords.T
    return idx[:, ::-1].copy()  # flip(1)


def _shift_attn_mask(h_pad: int, w_pad: int, window: int, shift: int) -> np.ndarray:
    """SW-MSA attention mask, (nW, N, N): 0 on same-region pairs and -100
    across the cyclic shift's seams."""
    img = np.zeros((h_pad, w_pad), np.float32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    m = img.reshape(h_pad // window, window, w_pad // window, window)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window * window)
    attn = m[:, None, :] - m[:, :, None]
    return np.where(attn != 0, -100.0, 0.0).astype(np.float32)


class ShapeConstants:
    """Shape-dependent constants (attention masks, positional embeddings,
    reference points), made once per shape and device from numpy, as JAX
    bakes them in at trace time. Not part of any ``state_dict``."""

    def __init__(self):
        self._cache = {}

    def get(self, key, device, make):
        key = key + (str(device),)
        if key not in self._cache:
            self._cache[key] = torch.from_numpy(np.ascontiguousarray(make())).to(device)
        return self._cache[key]


def _window_partition(x, window: int):
    """(B, H, W, C) -> (B*nW, window*window, C), H and W multiples of window."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _window_reverse(x, window: int, h: int, w: int):
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, x.shape[-1])


class WindowMSA(nn.Module):
    """W-MSA with a relative position bias over (B*nW, N, C) windows."""

    def __init__(self, embed_dims: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (embed_dims // num_heads) ** -0.5
        n_rel = (2 * window_size - 1) ** 2
        self.relative_position_bias_table = nn.Parameter(torch.zeros(n_rel, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            _rel_position_index(window_size, window_size)))
        self.qkv = nn.Linear(embed_dims, 3 * embed_dims, bias=qkv_bias)
        self.proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, x, mask=None):
        """x (B*nW, N, C); mask (nW, N, N) additive or None."""
        b, n, c = x.shape
        nh = self.num_heads
        q, k, v = self.qkv(x).reshape(b, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)  # (b, nh, n, n)
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        attn = attn + bias.reshape(n, n, nh).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b // nw, nw, nh, n, n) + mask[None, :, None]).reshape(b, nh, n, n)
        out = (attn.softmax(-1) @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class ShiftWindowMSA(WindowMSA):
    """(S)W-MSA over a padded, cyclically shifted (B, H*W, C) map."""

    def __init__(self, embed_dims: int, num_heads: int, window_size: int,
                 shift_size: int, qkv_bias: bool = True):
        super().__init__(embed_dims, num_heads, window_size, qkv_bias)
        self.window_size, self.shift_size = window_size, shift_size
        self.masks = ShapeConstants()  # per padded size

    def forward(self, x, hw_shape: Tuple[int, int]):
        b, _, c = x.shape
        h, w = hw_shape
        win, shift = self.window_size, self.shift_size
        x = x.reshape(b, h, w, c)
        pad_r, pad_b = (win - w % win) % win, (win - h % win) % win
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = self.masks.get((hp, wp), x.device,
                                  lambda: _shift_attn_mask(hp, wp, win, shift))
        x = _window_reverse(super().forward(_window_partition(x, win), mask), win, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        return x[:, :h, :w].reshape(b, h * w, c)


class SwinFFN(nn.Module):
    """2-fc exact-GELU FFN; the identity is added by the caller."""

    def __init__(self, embed_dims: int, feedforward_channels: int):
        super().__init__()
        self.fc1 = nn.Linear(embed_dims, feedforward_channels)
        self.fc2 = nn.Linear(feedforward_channels, embed_dims)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """Pre-LN attention + FFN residual block."""

    def __init__(self, embed_dims: int, num_heads: int, feedforward_channels: int,
                 window_size: int = 7, shift: bool = False, qkv_bias: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(embed_dims, eps=1e-5)
        self.attn = ShiftWindowMSA(embed_dims, num_heads, window_size,
                                   window_size // 2 if shift else 0, qkv_bias)
        self.norm2 = nn.LayerNorm(embed_dims, eps=1e-5)
        self.mlp = SwinFFN(embed_dims, feedforward_channels)

    def forward(self, x, hw_shape):
        x = x + self.attn(self.norm1(x), hw_shape)
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """Non-overlapping conv patchify + LN; 'corner' padding (bottom and right)
    to a multiple of the stride. NHWC in, (B, h*w, C) and (h, w) out."""

    def __init__(self, in_channels: int, embed_dims: int, patch_size: int = 4):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_channels, embed_dims, patch_size, patch_size)
        self.norm = nn.LayerNorm(embed_dims, eps=1e-5)

    def forward(self, x):
        b, h, w, _ = x.shape
        p = self.patch_size
        x = F.pad(x, (0, 0, 0, (p - w % p) % p, 0, (p - h % p) % p))
        x = conv_nhwc(x, self.proj, torch.float32)
        hw = (x.shape[1], x.shape[2])
        return self.norm(x.reshape(b, hw[0] * hw[1], -1)), hw


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated position-major -> LN -> linear 4C -> 2C;
    odd sizes padded at the bottom and right."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * in_channels, eps=1e-5)
        self.reduction = nn.Linear(4 * in_channels, out_channels, bias=False)

    def forward(self, x, hw_shape):
        b, _, c = x.shape
        h, w = hw_shape
        x = F.pad(x.reshape(b, h, w, c), (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        h2, w2 = x.shape[1], x.shape[2]
        return self.reduction(self.norm(x.reshape(b, h2 * w2, 4 * c))), (h2, w2)


class SwinStage(nn.Module):
    """One resolution: ``blocks`` (alternately shifted), then ``downsample``
    (None in the last stage)."""

    def __init__(self, dims: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: int, qkv_bias: bool, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dims, num_heads, mlp_ratio * dims, window_size, shift=i % 2 == 1,
                      qkv_bias=qkv_bias) for i in range(depth))
        self.downsample = PatchMerging(dims, 2 * dims) if downsample else None


class SwinTransformer(nn.Module):
    """Hierarchical Swin backbone: (B, H, W, 3) NHWC -> the LayerNormed NHWC
    features of the stages in ``out_indices`` (strides 4 * 2^i)."""

    def __init__(self, embed_dims: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: int = 4, out_indices: Sequence[int] = (1, 2, 3),
                 patch_size: int = 4, qkv_bias: bool = True, in_channels: int = 3):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(in_channels, embed_dims, patch_size)
        dims = [embed_dims * 2 ** i for i in range(len(depths))]
        self.num_features = dims
        self.layers = nn.ModuleList(
            SwinStage(dims[i], depths[i], num_heads[i], window_size, mlp_ratio, qkv_bias,
                      downsample=i < len(depths) - 1) for i in range(len(depths)))
        for i in self.out_indices:
            self.add_module(f"norm{i}", nn.LayerNorm(dims[i], eps=1e-5))

    def forward(self, images):
        b = images.shape[0]
        x, hw = self.patch_embed(images)
        outs = []
        for si, stage in enumerate(self.layers):
            for block in stage.blocks:
                x = block(x, hw)
            if si in self.out_indices:
                out = getattr(self, f"norm{si}")(x)
                outs.append(out.reshape(b, hw[0], hw[1], -1))
            if stage.downsample is not None:
                x, hw = stage.downsample(x, hw)
        return outs
