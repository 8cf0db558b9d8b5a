"""ResNet-101/50 backbone with DeepLabV3 dilation, and the DeepLabV3 head
that classifies depth under USE_DEPTH (torchvision names).

Counterpart of ``hgsfusion_tpu/models/resnet.py``: layer3/layer4 keep
stride 8 with dilations 2/4, the first block of a dilated stage using the
previous stage's dilation (torchvision ``_make_layer``). Returns the four
taps layer1..layer4 (strides 4, 8, 8, 8) as NHWC tensors. Internally the
backbone runs on NCHW views of channels-last memory. With ``quant="w8a8"``
(DDN QUANT, an eval-only serving knob) every convolution of the backbone is
the JAX package's ``QConv8``: ``ops/conv_int8.py::qconv2d``, the int8 kernel
``hgsfusion::conv2d_w8a8``; the parameters are the same ``nn.Conv2d``
weights, so a checkpoint loads unchanged. ``DeepLabClassifier``
is torchvision's ``DeepLabHead`` (ASPP, 3x3 conv-BN-ReLU, 1x1 logits).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.conv_int8 import qconv2d
from ..ops.matmul import matmul_f32
from ..utils.common import device_constant
from .layers import batch_norm, compute_dtype, conv_nhwc

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess_images(images):
    """ImageNet-normalize (B, H, W, 3), keeping zero-padded pixels at 0.
    uint8 images are scaled by 1/255 first."""
    mask = images == 0
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    mean = device_constant(IMAGENET_MEAN, images.dtype, images.device)
    std = device_constant(IMAGENET_STD, images.dtype, images.device)
    return torch.where(mask, torch.zeros((), dtype=images.dtype, device=images.device),
                       (images - mean) / std)


QUANT_MODES = ("none", "w8a8")


def _conv(x, conv, dtype, quant: str = "none"):
    """``conv`` on the NCHW view ``x`` in ``dtype``; under w8a8 the int8
    convolution of the NHWC memory beneath it."""
    if quant == "w8a8":
        return qconv2d(x.permute(0, 2, 3, 1), conv, dtype).permute(0, 3, 1, 2)
    return F.conv2d(x, conv.weight.to(dtype), None, conv.stride, conv.padding,
                    conv.dilation)


def _check_quant(quant: str):
    if quant not in QUANT_MODES:
        raise NotImplementedError(f"DDN QUANT={quant!r} (supported: none, w8a8)")


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False, dtype=None,
                 quant: str = "none"):
        super().__init__()
        _check_quant(quant)
        self.dtype = dtype
        self.quant = quant
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, dilation, dilation, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                nn.BatchNorm2d(planes * 4))

    def forward(self, x):
        """x: NCHW in the compute dtype."""
        dt, q = compute_dtype(self.dtype), self.quant
        out = torch.relu_(batch_norm(_conv(x, self.conv1, dt, q), self.bn1, dt, 1))
        out = torch.relu_(batch_norm(_conv(out, self.conv2, dt, q), self.bn2, dt, 1))
        out = batch_norm(_conv(out, self.conv3, dt, q), self.bn3, dt, 1)
        identity = x
        if self.downsample is not None:
            identity = batch_norm(_conv(x, self.downsample[0], dt, q), self.downsample[1], dt, 1)
        return torch.relu_(out + identity)


class ResNetDeepLabBackbone(nn.Module):
    """ResNet with (3,4,23,3) (101) or (3,4,6,3) (50) bottleneck stages."""

    def __init__(self, stage_sizes=(3, 4, 23, 3), dtype=None, quant: str = "none"):
        super().__init__()
        _check_quant(quant)
        self.dtype = dtype
        self.quant = quant
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        stage_cfg = [(64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4)]
        inplanes, prev_dilation = 64, 1
        for si, ((planes, stride, dilation), blocks) in enumerate(zip(stage_cfg, stage_sizes)):
            layer = [Bottleneck(inplanes, planes, stride, prev_dilation, True, dtype, quant)]
            inplanes = planes * 4
            layer += [Bottleneck(inplanes, planes, 1, dilation, False, dtype, quant)
                      for _ in range(1, blocks)]
            self.add_module(f"layer{si + 1}", nn.Sequential(*layer))
            prev_dilation = dilation

    def forward(self, images):
        """images (B, H, W, 3) -> [layer1 (C=256, /4), layer2 (512, /8),
        layer3 (1024, /8), layer4 (2048, /8)], NHWC in the compute dtype."""
        dt = compute_dtype(self.dtype)
        x = images.to(dt).permute(0, 3, 1, 2)
        x = torch.relu_(batch_norm(_conv(x, self.conv1, dt, self.quant), self.bn1, dt, 1))
        x = F.max_pool2d(x, 3, 2, 1)
        taps = []
        for name in ("layer1", "layer2", "layer3", "layer4"):
            x = getattr(self, name)(x)
            taps.append(x.permute(0, 2, 3, 1))
        return taps


def dilated_conv3x3(x, weight, dilation: int, dtype):
    """A 3x3 convolution with padding and dilation ``dilation``, no bias,
    on (B, H, W, C): the sum of its nine taps' products (``matmul_f32`` of
    the shifted map and the tap's (C, O) kernel), in f32, rounded once to
    ``dtype``. A tap whose window lies wholly in the zero padding adds
    nothing and is skipped. cuDNN runs the ASPP's dilations (12, 24, 36) on
    channels-last memory in 178-273 ms each on an H100, 7.4-7.9 ms on NCHW
    memory; this form takes 1.4 ms (``compare_dilated_conv.py``)."""
    b, h, w, c = x.shape
    d = dilation
    xp = F.pad(x.to(dtype), (0, 0, d, d, d, d))
    kernel = weight.to(dtype)
    out = None
    for ky in range(3):
        if ky != 1 and d >= h:
            continue
        for kx in range(3):
            if kx != 1 and d >= w:
                continue
            tap = xp[:, ky * d:ky * d + h, kx * d:kx * d + w].reshape(-1, c)
            y = matmul_f32(tap, kernel[:, :, ky, kx].t())
            out = y if out is None else out + y
    return out.to(dtype).view(b, h, w, -1)


class ASPPModule(nn.Module):
    """DeepLabV3 ASPP: a 1x1 branch, three dilated 3x3 branches and an
    image-pooling branch, concatenated and projected (torchvision ``ASPP``:
    ``convs.{0..4}``, ``project``). The JAX module's projection has no
    Dropout(0.5) after its ReLU, so neither has this one's forward; the
    index of torchvision's is kept, empty. BatchNorms follow
    ``layers.batch_norm``: at B=1 in train mode the pooling branch's sees
    one value per channel, variance 0, as in flax."""

    def __init__(self, in_channels: int, out_channels: int = 256,
                 atrous_rates=(12, 24, 36), dtype=None):
        super().__init__()
        self.dtype = dtype
        convs = [nn.Sequential(nn.Conv2d(in_channels, out_channels, 1, bias=False),
                               nn.BatchNorm2d(out_channels), nn.ReLU())]
        convs += [nn.Sequential(nn.Conv2d(in_channels, out_channels, 3, padding=r, dilation=r,
                                          bias=False),
                                nn.BatchNorm2d(out_channels), nn.ReLU())
                  for r in atrous_rates]
        convs.append(nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                   nn.Conv2d(in_channels, out_channels, 1, bias=False),
                                   nn.BatchNorm2d(out_channels), nn.ReLU()))
        self.convs = nn.ModuleList(convs)
        self.project = nn.Sequential(
            nn.Conv2d(len(convs) * out_channels, out_channels, 1, bias=False),
            nn.BatchNorm2d(out_channels), nn.ReLU(), nn.Identity())

    def forward(self, x):
        """x (B, H, W, C) -> (B, H, W, out_channels) in the compute dtype.
        The dilated branches run as ``dilated_conv3x3``; under a gradient
        each is recomputed in the backward pass instead of keeping its nine
        shifted copies of the map."""
        dt = compute_dtype(self.dtype)
        branches = [torch.relu(batch_norm(conv_nhwc(x, self.convs[0][0], dt),
                                          self.convs[0][1], dt))]
        for branch in self.convs[1:-1]:
            conv = branch[0]
            if torch.is_grad_enabled() and conv.weight.requires_grad:
                y = checkpoint(dilated_conv3x3, x, conv.weight, conv.dilation[0], dt,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                y = dilated_conv3x3(x, conv.weight, conv.dilation[0], dt)
            branches.append(torch.relu(batch_norm(y, branch[1], dt)))
        pool = self.convs[-1]
        g = x.mean(dim=(1, 2), keepdim=True)
        g = torch.relu(batch_norm(conv_nhwc(g, pool[1], dt), pool[2], dt))
        branches.append(g.expand(x.shape[:3] + (g.shape[-1],)))
        h = torch.cat(branches, dim=-1)
        return torch.relu(batch_norm(conv_nhwc(h, self.project[0], dt), self.project[1], dt))


class DeepLabClassifier(nn.Sequential):
    """ASPP -> 3x3 conv-BN-ReLU -> 1x1 logits with a bias, in f32
    (torchvision ``DeepLabHead``: ``0`` ASPP, ``1`` conv, ``2`` BN, ``4``
    logits, whose outputs are the D + 1 depth bins as in the reference's
    ``ddn_template``)."""

    def __init__(self, in_channels: int, num_classes: int, dtype=None):
        super().__init__(ASPPModule(in_channels, dtype=dtype),
                         nn.Conv2d(256, 256, 3, padding=1, bias=False),
                         nn.BatchNorm2d(256), nn.ReLU(),
                         nn.Conv2d(256, num_classes, 1))
        self.dtype = dtype

    def forward(self, x):
        """x (B, H, W, C) -> logits (B, H, W, num_classes), f32."""
        dt = compute_dtype(self.dtype)
        h = self[0](x)
        h = torch.relu(batch_norm(conv_nhwc(h, self[1], dt), self[2], dt))
        return conv_nhwc(h, self[4], torch.float32)
