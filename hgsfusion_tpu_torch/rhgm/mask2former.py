"""Mask2Former instance segmentation, the RHGM mask source (counterpart of
``hgsfusion_tpu/rhgm/mask2former.py``), NHWC at its boundaries.

The reference's hybrid-point generator runs a pretrained swin-L Cityscapes
Mask2Former through detectron2. This module computes what the JAX package's
does, with the published checkpoint's parameter names: ``backbone.*``
(``models/swin.py``), ``sem_seg_head.pixel_decoder.*`` and
``sem_seg_head.predictor.*``. A published ``state_dict`` therefore loads
with ``load_state_dict`` (``rhgm/checkpoint.py``), and
``weights.from_jax_mask2former`` converts the JAX package's variables.

- backbone: ``SwinTransformer`` with every stage's output;
- pixel decoder, by ``pixel_decoder``: "msdeform" (MSDeformAttnPixelDecoder,
  what the published weights were trained with: a deformable-attention
  encoder over the three coarsest scales and one FPN step onto stride 4) or
  "fpn" (a top-down FPN; its names are detectron2 BasePixelDecoder's,
  ``adapter_{i}`` lateral and ``layer_{i}`` output convolutions);
- transformer decoder: learned queries, post-norm layers of masked
  cross-attention -> self-attention -> FFN cycling over the three
  coarsest scales, a prediction head after every layer.

Deformable sampling is ``F.grid_sample`` (bilinear, zeros padding,
align_corners=False) with the heads folded into the batch, as Deformable
DETR's PyTorch core computes it; the JAX package computes the same taps as
an XLA gather. Everything runs in f32.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.detector import _Scope, resolve_device
from ..models.layers import conv_nhwc, resize_bilinear
from ..models.swin import ShapeConstants, SwinTransformer, WindowMSA

# Cityscapes instance classes, index == one-hot label bin of the RHGM output
# files
CITYSCAPES_THINGS = (
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
)


def sine_position_embedding(h: int, w: int, channels: int, temperature: float = 10000.0):
    """2-D sine positional embedding, detectron2 PositionEmbeddingSine
    semantics (normalize=True, scale=2*pi): (h, w, channels) numpy f32."""
    half = channels // 2
    eps = 1e-6
    y = np.arange(1, h + 1, dtype=np.float32)[:, None] / (h + eps) * 2 * np.pi
    x = np.arange(1, w + 1, dtype=np.float32)[None, :] / (w + eps) * 2 * np.pi
    dim_t = temperature ** (2 * (np.arange(half, dtype=np.float32) // 2) / half)
    pos_x = np.broadcast_to(x[..., None], (h, w, half)) / dim_t
    pos_y = np.broadcast_to(y[..., None], (h, w, half)) / dim_t
    # interleave sin/cos over pairs, then (pos_y, pos_x) along channels
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])],
                     axis=-1).reshape(h, w, half)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])],
                     axis=-1).reshape(h, w, half)
    return np.concatenate([pos_y, pos_x], axis=-1)


def _group_norm(x, gn: nn.GroupNorm):
    """GroupNorm of a (B, H, W, C) tensor."""
    return F.group_norm(x.permute(0, 3, 1, 2), gn.num_groups, gn.weight, gn.bias,
                        gn.eps).permute(0, 2, 3, 1)


class _ConvGN(nn.Conv2d):
    """Conv2d + GroupNorm(32) (+ ReLU), bias-free: detectron2's Conv2d with a
    ``norm`` (``<name>.weight``, ``<name>.norm.{weight, bias}``)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, relu: bool = True):
        super().__init__(in_channels, features, kernel, padding=kernel // 2, bias=False)
        self.norm = nn.GroupNorm(32, features, eps=1e-5)
        self.relu = relu

    def forward(self, x):
        y = _group_norm(conv_nhwc(x, self, torch.float32), self.norm)
        return torch.relu(y) if self.relu else y


class PixelDecoderFPN(nn.Module):
    """BasePixelDecoder: top-down FPN over the backbone pyramid.

    inputs: NHWC features, highest stride last ([res2, res3, res4, res5]).
    Returns (mask_features (B, H/4, W/4, mask_dim), the three lowest-
    resolution maps, lowest first)."""

    def __init__(self, in_channels: Sequence[int], conv_dim: int = 256, mask_dim: int = 256):
        super().__init__()
        n = len(in_channels)
        self.n = n
        self.add_module(f"layer_{n}", _ConvGN(in_channels[-1], conv_dim))
        for i in range(n - 1):
            self.add_module(f"adapter_{i + 1}", _ConvGN(in_channels[i], conv_dim, 1, relu=False))
            self.add_module(f"layer_{i + 1}", _ConvGN(conv_dim, conv_dim))
        self.mask_features = nn.Conv2d(conv_dim, mask_dim, 3, padding=1)

    def forward(self, inputs):
        n = self.n
        y = getattr(self, f"layer_{n}")(inputs[-1])
        outs = [y]
        for i in range(n - 2, -1, -1):
            lat = getattr(self, f"adapter_{i + 1}")(inputs[i])
            y = getattr(self, f"layer_{i + 1}")(lat + resize_bilinear(y, lat.shape[1:3]))
            outs.append(y)
        return conv_nhwc(outs[-1], self.mask_features, torch.float32), outs[:3]


def _deform_sample_level(value, loc):
    """Bilinear taps of one value level at deformable sampling locations.

    value (B, H, W, heads, dh); loc (B, Q, heads, P, 2) normalized (x, y):
    pixel coordinates px = x * W - 0.5, taps outside the map read 0.
    Returns (B, Q, heads, P, dh)."""
    b, h, w, nh, dh = value.shape
    q, p = loc.shape[1], loc.shape[3]
    v = value.permute(0, 3, 4, 1, 2).reshape(b * nh, dh, h, w)
    grid = (2 * loc - 1).permute(0, 2, 1, 3, 4).reshape(b * nh, q, p, 2)
    out = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    return out.reshape(b, nh, dh, q, p).permute(0, 3, 1, 4, 2)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention (Deformable DETR), the self-attention
    of the MSDeformAttn pixel decoder's encoder."""

    def __init__(self, d_model: int = 256, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.d_model, self.n_levels, self.n_heads, self.n_points = (
            d_model, n_levels, n_heads, n_points)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, reference_points, value_levels):
        """query (B, Q, C), already pos-embedded; reference_points
        (B, Q, n_levels, 2) normalized (x, y); value_levels: the
        (B, H_l, W_l, C) sources, not pos-embedded. Returns (B, Q, C)."""
        c, nh, nl, npt = self.d_model, self.n_heads, self.n_levels, self.n_points
        dh = c // nh
        b, q = query.shape[:2]
        offsets = self.sampling_offsets(query).reshape(b, q, nh, nl, npt, 2)
        attn = self.attention_weights(query).reshape(b, q, nh, nl * npt).softmax(-1)
        attn = attn.reshape(b, q, nh, nl, npt)
        acc = query.new_zeros((b, q, nh, dh))
        for lvl, v in enumerate(value_levels):
            hl, wl = v.shape[1:3]
            val = self.value_proj(v).reshape(b, hl, wl, nh, dh)
            norm = torch.tensor([wl, hl], dtype=query.dtype, device=query.device)
            loc = reference_points[:, :, None, lvl, None, :] + offsets[:, :, :, lvl] / norm
            tap = _deform_sample_level(val, loc)  # (B, Q, nh, P, dh)
            acc = acc + (tap * attn[:, :, :, lvl, :, None]).sum(3)
        return self.output_proj(acc.reshape(b, q, c))


class _MSDeformEncoderLayer(nn.Module):
    """Deformable self-attention + ReLU FFN, post-norm."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024, n_levels: int = 3,
                 n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, reference_points, value_levels):
        src = self.norm1(src + self.self_attn(src + pos, reference_points, value_levels))
        return self.norm2(src + self.linear2(torch.relu(self.linear1(src))))


def _reference_points(hws) -> np.ndarray:
    """Each query's own normalized pixel centre, (sum h*w, 2) (x, y)."""
    refs = []
    for h, w in hws:
        ry, rx = np.meshgrid((np.arange(h, dtype=np.float32) + 0.5) / h,
                             (np.arange(w, dtype=np.float32) + 0.5) / w, indexing="ij")
        refs.append(np.stack([rx, ry], -1).reshape(-1, 2))
    return np.concatenate(refs, 0)


class PixelDecoderMSDeform(nn.Module):
    """MSDeformAttnPixelDecoder: a deformable-attention encoder over the three
    coarsest scales (res5, res4, res3 after 1x1 conv + GN projections), one
    FPN step fusing its stride-8 output with res2 (``adapter_1``, ``layer_1``)
    and a 3x3 ``mask_features`` conv. Same contract as PixelDecoderFPN."""

    def __init__(self, in_channels: Sequence[int], conv_dim: int = 256, mask_dim: int = 256,
                 enc_layers: int = 6, n_heads: int = 8, n_points: int = 4, d_ffn: int = 1024):
        super().__init__()
        levels = list(in_channels)[:0:-1]  # res5, res4, res3
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(cin, conv_dim, 1), nn.GroupNorm(32, conv_dim, eps=1e-5))
            for cin in levels)
        self.transformer = _Scope(
            level_embed=nn.Parameter(torch.zeros(len(levels), conv_dim)),
            encoder=_Scope(layers=nn.ModuleList(
                _MSDeformEncoderLayer(conv_dim, d_ffn, len(levels), n_heads, n_points)
                for _ in range(enc_layers))))
        self.adapter_1 = _ConvGN(in_channels[0], conv_dim, 1, relu=False)
        self.layer_1 = _ConvGN(conv_dim, conv_dim)
        self.mask_features = nn.Conv2d(conv_dim, mask_dim, 3, padding=1)
        self.constants = ShapeConstants()

    def forward(self, inputs):
        c = self.mask_features.in_channels
        b = inputs[0].shape[0]
        dev = inputs[0].device
        srcs, poss, hws = [], [], []
        for proj, f in zip(self.input_proj, inputs[:0:-1]):
            y = _group_norm(conv_nhwc(f, proj[0], torch.float32), proj[1])
            h, w = y.shape[1:3]
            srcs.append(y.reshape(b, h * w, c))
            poss.append(self.constants.get(("pos", h, w, c), dev,
                                           lambda: sine_position_embedding(h, w, c))
                        .reshape(1, h * w, c))
            hws.append((h, w))
        level_embed = self.transformer.level_embed
        pos_flat = torch.cat([p + level_embed[i][None, None] for i, p in enumerate(poss)], 1)
        x = torch.cat(srcs, 1)
        refs = self.constants.get(("ref",) + tuple(hws), dev, lambda: _reference_points(hws))
        ref_points = refs[None, :, None, :].expand(b, refs.shape[0], len(hws), 2)

        def split(t):
            maps, start = [], 0
            for h, w in hws:
                maps.append(t[:, start:start + h * w].reshape(b, h, w, c))
                start += h * w
            return maps

        for layer in self.transformer.encoder.layers:
            # the value levels are the current x re-split into maps
            x = layer(x, pos_flat, ref_points, split(x))
        outs = split(x)
        lat = self.adapter_1(inputs[0])
        y = self.layer_1(lat + resize_bilinear(outs[-1], lat.shape[1:3]))
        return conv_nhwc(y, self.mask_features, torch.float32), outs  # strides 32, 16, 8


class _MHA(nn.Module):
    """Multi-head attention with an additive (B, Q, N) bool key mask (True =
    do not attend: -1e9 on the logit). torch MultiheadAttention's parameter
    layout: ``in_proj_weight`` rows [Wq; Wk; Wv], ``out_proj``."""

    def __init__(self, channels: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * channels, channels))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * channels))
        self.out_proj = nn.Linear(channels, channels)

    def forward(self, q, k, v, key_mask=None):
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        b, nq, c = q.shape
        nk, h = k.shape[1], self.heads
        d = c // h
        qp = F.linear(q, wq, bq).reshape(b, nq, h, d).transpose(1, 2)
        kp = F.linear(k, wk, bk).reshape(b, nk, h, d).transpose(1, 2)
        vp = F.linear(v, wv, bv).reshape(b, nk, h, d).transpose(1, 2)
        logits = (qp @ kp.transpose(-2, -1)) / math.sqrt(d)
        if key_mask is not None:
            logits = logits.masked_fill(key_mask[:, None], -1e9)
        out = (logits.softmax(-1) @ vp).transpose(1, 2).reshape(b, nq, c)
        return self.out_proj(out)


class _MaskMLP(nn.Module):
    """3-layer ReLU MLP mask head (``layers.{0, 1, 2}``)."""

    def __init__(self, channels: int, hidden: int, out: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [nn.Linear(channels, hidden), nn.Linear(hidden, hidden), nn.Linear(hidden, out)])

    def forward(self, x):
        x = torch.relu(self.layers[0](x))
        return self.layers[2](torch.relu(self.layers[1](x)))


class MaskedTransformerDecoder(nn.Module):
    """MultiScaleMaskedTransformerDecoder: masked cross-attention cycling over
    three scales, post-norm, a prediction head after every layer (the last
    one's predictions are returned). The scales have ``hidden_dim``
    channels, as the pixel decoders give them (no input projection)."""

    def __init__(self, num_classes: int = 8, hidden_dim: int = 256, num_queries: int = 100,
                 num_heads: int = 8, num_layers: int = 9, dim_feedforward: int = 2048,
                 mask_dim: int = 256, n_scales: int = 3):
        super().__init__()
        c = hidden_dim
        self.num_layers = num_layers
        self.transformer_self_attention_layers = nn.ModuleList(
            _Scope(self_attn=_MHA(c, num_heads), norm=nn.LayerNorm(c, eps=1e-5))
            for _ in range(num_layers))
        self.transformer_cross_attention_layers = nn.ModuleList(
            _Scope(multihead_attn=_MHA(c, num_heads), norm=nn.LayerNorm(c, eps=1e-5))
            for _ in range(num_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            _Scope(linear1=nn.Linear(c, dim_feedforward), linear2=nn.Linear(dim_feedforward, c),
                   norm=nn.LayerNorm(c, eps=1e-5))
            for _ in range(num_layers))
        self.decoder_norm = nn.LayerNorm(c, eps=1e-5)
        self.query_feat = nn.Embedding(num_queries, c)
        self.query_embed = nn.Embedding(num_queries, c)
        self.level_embed = nn.Embedding(n_scales, c)
        self.class_embed = nn.Linear(c, num_classes + 1)
        self.mask_embed = _MaskMLP(c, c, mask_dim)
        self.constants = ShapeConstants()

    def forward(self, scales, mask_features):
        c = self.query_feat.embedding_dim
        q = self.query_feat.num_embeddings
        b = mask_features.shape[0]
        srcs, poss, hws = [], [], []
        for i, f in enumerate(scales):
            h, w = f.shape[1:3]
            srcs.append(f.reshape(b, h * w, c) + self.level_embed.weight[i])
            poss.append(self.constants.get(("pos", h, w, c), f.device,
                                           lambda: sine_position_embedding(h, w, c))
                        .reshape(1, h * w, c))
            hws.append((h, w))

        def predict(x):
            y = self.decoder_norm(x)
            emb = self.mask_embed(y)
            return self.class_embed(y), torch.einsum("bqc,bhwc->bqhw", emb, mask_features)

        def attn_mask_for(masks, hw):
            # (B, Q, h*w) True = do not attend; a query blocked everywhere
            # is unblocked (detectron2's sum == len reset)
            m = resize_bilinear(masks.permute(0, 2, 3, 1), hw).permute(0, 3, 1, 2).reshape(b, q, -1)
            blocked = torch.sigmoid(m) < 0.5
            return blocked & ~blocked.all(-1, keepdim=True)

        x = self.query_feat.weight[None].expand(b, q, c)
        qe = self.query_embed.weight[None]
        cls, masks = predict(x)
        for li in range(self.num_layers):
            si = li % len(scales)
            km = attn_mask_for(masks, hws[si])
            cross = self.transformer_cross_attention_layers[li]
            x = cross.norm(x + cross.multihead_attn(x + qe, srcs[si] + poss[si], srcs[si],
                                                    key_mask=km))
            sa = self.transformer_self_attention_layers[li]
            x = sa.norm(x + sa.self_attn(x + qe, x + qe, x))
            ffn = self.transformer_ffn_layers[li]
            x = ffn.norm(x + ffn.linear2(torch.relu(ffn.linear1(x))))
            cls, masks = predict(x)
        return cls, masks


def init_weights(model: nn.Module, generator: torch.Generator):
    """Random weights from ``generator``: LeCun-normal kernels and attention
    projections, zero biases, N(0, 1) embeddings, the relative-position bias
    tables N(0, 0.02); the norms keep their identity initialization."""
    def lecun(w):
        w.normal_(0.0, 1.0 / math.sqrt(w.numel() // w.shape[0]), generator=generator)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun(m.weight)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, _MHA):
                lecun(m.in_proj_weight)
                m.in_proj_bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=generator)
            elif isinstance(m, WindowMSA):
                m.relative_position_bias_table.normal_(0.0, 0.02, generator=generator)
            elif isinstance(m, PixelDecoderMSDeform):
                m.transformer.level_embed.normal_(0.0, 1.0, generator=generator)


class Mask2FormerInstance(nn.Module):
    """Image (B, H, W, 3) -> {"pred_logits" (B, Q, K+1), "pred_masks"
    (B, Q, H/4, W/4)}. The defaults are swin-L's, the reference's generation
    config; pass small dims for tests. ``device`` defaults to "cuda" and
    raises without a CUDA device; the weights are drawn from ``seed`` on the
    CPU, so they are the same on any device."""

    def __init__(self, num_classes: int = 8, embed_dims: int = 192,
                 depths: Sequence[int] = (2, 2, 18, 2), num_heads: Sequence[int] = (6, 12, 24, 48),
                 window_size: int = 12, hidden_dim: int = 256, num_queries: int = 100,
                 dec_heads: int = 8, dec_layers: int = 9, dim_feedforward: int = 2048,
                 pixel_decoder: str = "msdeform", pd_enc_layers: int = 6, pd_ffn: int = 1024,
                 device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.backbone = SwinTransformer(embed_dims, depths, num_heads, window_size,
                                        out_indices=(0, 1, 2, 3))
        in_ch = self.backbone.num_features
        if pixel_decoder == "msdeform":
            pd = PixelDecoderMSDeform(in_ch, hidden_dim, hidden_dim, pd_enc_layers, d_ffn=pd_ffn)
        elif pixel_decoder == "fpn":
            pd = PixelDecoderFPN(in_ch, hidden_dim, hidden_dim)
        else:
            raise ValueError(f"pixel_decoder {pixel_decoder!r}: 'msdeform' or 'fpn'")
        self.sem_seg_head = _Scope(
            pixel_decoder=pd,
            predictor=MaskedTransformerDecoder(num_classes, hidden_dim, num_queries, dec_heads,
                                               dec_layers, dim_feedforward, hidden_dim))
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.backbone.patch_embed.proj.weight.device

    def forward(self, images):
        feats = self.backbone(images)
        mask_features, scales = self.sem_seg_head.pixel_decoder(feats)
        cls, masks = self.sem_seg_head.predictor(scales, mask_features)
        return {"pred_logits": cls, "pred_masks": masks}


def instance_inference(pred_logits, pred_masks, image_hw: Tuple[int, int], topk: int = 100):
    """detectron2 instance_inference of the first image: the top ``topk``
    (query, class) pairs of the flattened class scores, masks binarized at
    0, score = class prob x mean in-mask sigmoid. Returns (labels (T,),
    scores (T,), masks (T, H, W) bool); an empty mask scores 0."""
    q, kp1 = pred_logits.shape[-2:]
    k = kp1 - 1
    scores = pred_logits[0].softmax(-1)[:, :-1].reshape(-1)
    top_scores, top_idx = torch.topk(scores, min(topk, q * k))
    labels = top_idx % k
    qidx = top_idx // k
    masks = resize_bilinear(pred_masks[0].permute(1, 2, 0)[None], image_hw)[0]
    masks = masks.permute(2, 0, 1)[qidx]
    binary = masks > 0
    prob = torch.sigmoid(masks)
    denom = torch.clamp(binary.sum((1, 2)), min=1)
    mask_score = (prob * binary).sum((1, 2)) / denom
    return labels, top_scores * mask_score * binary.any(2).any(1), binary
