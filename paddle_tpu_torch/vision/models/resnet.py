"""ResNet (the port of ``paddle_tpu/vision/models/resnet.py:14-203``).

Same module tree and parameter names as the reference (``conv1.weight``,
``bn1._mean``, ``layer1.0.downsample.1._variance``, ...), so ``convert.py``
carries weights and BatchNorm statistics across by name; convolution
weights keep the reference's OIHW layout. ``data_format="NHWC"`` (what
``bench.py`` trains) takes and passes ``[N, H, W, C]`` tensors, which every
layer reads as channels-last NCHW views: the network runs in
``torch.channels_last`` memory format from the input to the pool, with no
transposing copy between layers (``nn/functional/conv.py``).

The model is built on ``device`` (default: the CUDA device; ``device="cpu"``
must be asked for) in ``dtype``, its parameters drawn from a
``torch.Generator`` seeded with ``seed``: convolutions KaimingUniform,
BatchNorm 1/0 with zero means and unit variances, the classifier
``U(±1 / sqrt(fan_in))``. ``resnext*`` and ``wide_resnet*`` (groups and
widths other than 1 and 64) wait for ROADMAP queue 1 item 5d.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

from ...framework.device import resolve_device
from ...nn.layer import AdaptiveAvgPool2D, BatchNorm2D, Conv2D, MaxPool2D

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", *, device=None, dtype=None):
        super().__init__()
        kw = dict(data_format=data_format, device=device, dtype=dtype)
        norm_layer = norm_layer or functools.partial(BatchNorm2D, **kw)
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                            bias_attr=False, **kw)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **kw)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", *, device=None, dtype=None):
        super().__init__()
        kw = dict(data_format=data_format, device=device, dtype=dtype)
        norm_layer = norm_layer or functools.partial(BatchNorm2D, **kw)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = norm_layer(width)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation,
                            bias_attr=False, **kw)
        self.bn2 = norm_layer(width)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, **kw)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW", *,
                 device=None, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__()
        if width != 64 or groups != 1:
            raise NotImplementedError(
                "ResNeXt and wide ResNets (groups or widths other than 1 and "
                "64) are not ported yet (ROADMAP queue 1 item 5d)")
        device = resolve_device(device)
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = data_format
        self._kw = dict(data_format=data_format, device=device, dtype=dtype)
        self._norm_layer = functools.partial(BatchNorm2D, **self._kw)
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = Conv2D(3, self.inplanes, kernel_size=7, stride=2,
                            padding=3, bias_attr=False, **self._kw)
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1,
                                 data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1), data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                device=device, dtype=dtype)
        self.reset_parameters(seed)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **self._kw),
                self._norm_layer(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, self.dilation,
                        self._norm_layer, **self._kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=self._norm_layer, **self._kw))
        return nn.Sequential(*layers)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        if self.device.type == "meta":       # shapes only
            return
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        for module in self.modules():
            if isinstance(module, Conv2D):
                module.reset_parameters(g)
            elif isinstance(module, BatchNorm2D):
                module.reset_parameters()
            elif isinstance(module, nn.Linear):
                bound = 1.0 / math.sqrt(module.in_features)
                module.weight.uniform_(-bound, bound, generator=g)
                module.bias.uniform_(-bound, bound, generator=g)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def _resnet(block, depth, width=64, **kwargs):
    return ResNet(block, depth, width=width, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, **kwargs)
