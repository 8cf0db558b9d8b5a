"""ResNet-101/50 backbone with DeepLabV3 dilation (torchvision names).

Counterpart of ``hgsfusion_tpu/models/resnet.py``: layer3/layer4 keep
stride 8 with dilations 2/4, the first block of a dilated stage using the
previous stage's dilation (torchvision ``_make_layer``). Returns the four
taps layer1..layer4 (strides 4, 8, 8, 8) as NHWC tensors. Internally the
backbone runs on NCHW views of channels-last memory.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.common import device_constant
from .layers import batch_norm, compute_dtype

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


def _conv(x, conv, dtype):
    return F.conv2d(x, conv.weight.to(dtype), None, conv.stride, conv.padding,
                    conv.dilation)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False, dtype=None):
        super().__init__()
        self.dtype = dtype
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
        dt = compute_dtype(self.dtype)
        out = torch.relu_(batch_norm(_conv(x, self.conv1, dt), self.bn1, dt, 1))
        out = torch.relu_(batch_norm(_conv(out, self.conv2, dt), self.bn2, dt, 1))
        out = batch_norm(_conv(out, self.conv3, dt), self.bn3, dt, 1)
        identity = x
        if self.downsample is not None:
            identity = batch_norm(_conv(x, self.downsample[0], dt), self.downsample[1], dt, 1)
        return torch.relu_(out + identity)


class ResNetDeepLabBackbone(nn.Module):
    """ResNet with (3,4,23,3) (101) or (3,4,6,3) (50) bottleneck stages."""

    def __init__(self, stage_sizes=(3, 4, 23, 3), dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        stage_cfg = [(64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4)]
        inplanes, prev_dilation = 64, 1
        for si, ((planes, stride, dilation), blocks) in enumerate(zip(stage_cfg, stage_sizes)):
            layer = [Bottleneck(inplanes, planes, stride, prev_dilation, True, dtype)]
            inplanes = planes * 4
            layer += [Bottleneck(inplanes, planes, 1, dilation, False, dtype)
                      for _ in range(1, blocks)]
            self.add_module(f"layer{si + 1}", nn.Sequential(*layer))
            prev_dilation = dilation

    def forward(self, images):
        """images (B, H, W, 3) -> [layer1 (C=256, /4), layer2 (512, /8),
        layer3 (1024, /8), layer4 (2048, /8)], NHWC in the compute dtype."""
        dt = compute_dtype(self.dtype)
        x = images.to(dt).permute(0, 3, 1, 2)
        x = torch.relu_(batch_norm(_conv(x, self.conv1, dt), self.bn1, dt, 1))
        x = F.max_pool2d(x, 3, 2, 1)
        taps = []
        for name in ("layer1", "layer2", "layer3", "layer4"):
            x = getattr(self, name)(x)
            taps.append(x.permute(0, 2, 3, 1))
        return taps
