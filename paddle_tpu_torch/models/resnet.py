"""ResNet family — the port of ``paddle_tpu/models/resnet.py``:
``ConvBN``, ``BasicBlock``, ``Bottleneck``, ``SpaceToDepthStem``,
``ResNet`` (``resnet18/34/50/101/152``) and ``ResNetCifar``
(``resnet_cifar``). NHWC images, HWIO kernels and BatchNorm running
statistics as buffers, as in JAX.

Parameter and buffer names follow the JAX variable paths
(``stage0_block0.c1.conv.w`` is ``stage0_block0/c1/conv/w``,
``stem.bn.mean`` the state ``stem/bn/mean``), which is what
``utils/bridge.py`` relies on. Modules take their input channels
explicitly (JAX infers them at init), and a block gets its ``shortcut``
only where the JAX block creates its parameters: where the stride is not
1 or the input channels differ from the block's output.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ..core.device import resolve_device
from ..nn import activations
from ..nn.layers import BatchNorm, Conv2D, Linear, Pool2D

__all__ = ["BasicBlock", "Bottleneck", "ConvBN", "ResNet", "ResNetCifar",
           "SpaceToDepthStem", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "resnet_cifar"]


class _ResidualRelu(torch.autograd.Function):
    """``max(s, 0)`` of a residual sum ``s``, as the JAX blocks'
    ``jnp.maximum(h + x, 0.0)``: the forward is ``torch.relu``, and the
    gradient at a tie (``s == 0``, frequent in bf16) is 1/2, as
    ``lax.max``'s is, where ``torch.relu``'s is 0. It saves ``sign(s)``
    as int8 (one byte an element, where keeping ``s`` would hold a
    second activation-sized tensor beside the output), and the gradient
    is ``g * (sign + 1) / 2``."""

    @staticmethod
    def forward(ctx, s):
        ctx.save_for_backward(s.sign().to(torch.int8))
        return torch.relu(s)

    @staticmethod
    def backward(ctx, g):
        (sign,) = ctx.saved_tensors
        return (g * sign).add_(g).mul_(0.5)


class ConvBN(nn.Module):
    """conv (SAME, no bias) + batchnorm + activation."""

    def __init__(self, in_channels: int, features: int, kernel, stride=1,
                 act="relu", device=None, generator=None):
        super().__init__()
        self.conv = Conv2D(in_channels, features, kernel, stride=stride,
                           padding="SAME", use_bias=False, device=device,
                           generator=generator)
        self.bn = BatchNorm(features, device=device)
        self.act = activations.get(act)

    def forward(self, x, train: bool = False):
        return self.act(self.bn(self.conv(x), train=train))


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block."""

    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.c1 = ConvBN(in_channels, features, 3, stride=stride, **kw)
        self.c2 = ConvBN(features, features, 3, act="", **kw)
        self.shortcut = ConvBN(in_channels, features, 1, stride=stride,
                               act="", **kw) \
            if stride != 1 or in_channels != features else None

    def forward(self, x, train: bool = False):
        h = self.c2(self.c1(x, train=train), train=train)
        if self.shortcut is not None:
            x = self.shortcut(x, train=train)
        return _ResidualRelu.apply(h + x)


class Bottleneck(nn.Module):
    """1x1 - 3x3 - 1x1 bottleneck; the output has ``4 * features``
    channels."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        out = features * 4
        self.c1 = ConvBN(in_channels, features, 1, **kw)
        self.c2 = ConvBN(features, features, 3, stride=stride, **kw)
        self.c3 = ConvBN(features, out, 1, act="", **kw)
        self.shortcut = ConvBN(in_channels, out, 1, stride=stride, act="",
                               **kw) \
            if stride != 1 or in_channels != out else None

    def forward(self, x, train: bool = False):
        h = self.c3(self.c2(self.c1(x, train=train), train=train),
                    train=train)
        if self.shortcut is not None:
            x = self.shortcut(x, train=train)
        return _ResidualRelu.apply(h + x)


class SpaceToDepthStem(nn.Module):
    """2x2 input patches into channels (``[B, 224, 224, 3] -> [B, 112,
    112, 12]``), then a 4x4 stride-1 ConvBN."""

    def __init__(self, in_channels: int = 3, features: int = 64,
                 device=None, generator=None):
        super().__init__()
        self.conv = ConvBN(4 * in_channels, features, 4, stride=1,
                           device=device, generator=generator)

    def forward(self, x, train: bool = False):
        n, h, w, c = x.shape
        x = x.reshape(n, h // 2, 2, w // 2, 2, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
        return self.conv(x, train=train)


def _add_blocks(module: nn.Module, names: List[str], block, specs,
                in_channels: int, **kw) -> int:
    """Register ``block(in, features, stride)`` for each ``(name,
    features, stride)`` of ``specs`` under its JAX name; returns the last
    block's output channels."""
    for name, features, stride in specs:
        setattr(module, name, block(in_channels, features, stride=stride,
                                    **kw))
        names.append(name)
        in_channels = features * block.expansion
    return in_channels


class ResNet(nn.Module):
    """ImageNet-shape ResNet: stem (``"conv7"``, the 7x7/2 ConvBN, or
    ``"s2d"``), 3x3/2 max pool, four stages of ``block`` (64, 128, 256,
    512 features; stride 2 at the first block of stages 1-3), the spatial
    mean and the ``fc`` head."""

    def __init__(self, block, layers: Sequence[int], num_classes: int = 1000,
                 stem: str = "conv7", in_channels: int = 3, device="cuda",
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        if stem == "s2d":
            self.stem = SpaceToDepthStem(in_channels, 64, **kw)
        else:
            self.stem = ConvBN(in_channels, 64, 7, stride=2, **kw)
        self.pool = Pool2D("max", 3, stride=2, padding="SAME")
        self.block_names: List[str] = []
        specs = [(f"stage{si}_block{bi}", f, 2 if si > 0 and bi == 0 else 1)
                 for si, (f, n) in enumerate(zip([64, 128, 256, 512],
                                                 layers))
                 for bi in range(n)]
        width = _add_blocks(self, self.block_names, block, specs, 64, **kw)
        self.fc = Linear(width, num_classes, **kw)

    def forward(self, x, train: bool = False):
        h = self.pool(self.stem(x, train=train))
        for name in self.block_names:
            h = getattr(self, name)(h, train=train)
        return self.fc(h.mean((1, 2)))


def resnet18(num_classes=1000, **kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, **kw)


def resnet34(num_classes=1000, **kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet50(num_classes=1000, stem="conv7", **kw):
    return ResNet(Bottleneck, [3, 4, 6, 3], num_classes, stem=stem, **kw)


def resnet101(num_classes=1000, **kw):
    return ResNet(Bottleneck, [3, 4, 23, 3], num_classes, **kw)


def resnet152(num_classes=1000, **kw):
    return ResNet(Bottleneck, [3, 8, 36, 3], num_classes, **kw)


class ResNetCifar(nn.Module):
    """CIFAR-shape ResNet: a 3x3 ConvBN stem of 16 features, three stages
    of ``depth_n`` BasicBlocks (16, 32, 64 features), the spatial mean and
    the ``fc`` head."""

    def __init__(self, depth_n: int = 3, num_classes: int = 10,
                 in_channels: int = 3, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.stem = ConvBN(in_channels, 16, 3, **kw)
        self.block_names: List[str] = []
        specs = [(f"s{si}_b{bi}", f, 2 if si > 0 and bi == 0 else 1)
                 for si, f in enumerate([16, 32, 64])
                 for bi in range(depth_n)]
        width = _add_blocks(self, self.block_names, BasicBlock, specs, 16,
                            **kw)
        self.fc = Linear(width, num_classes, **kw)

    def forward(self, x, train: bool = False):
        h = self.stem(x, train=train)
        for name in self.block_names:
            h = getattr(self, name)(h, train=train)
        return self.fc(h.mean((1, 2)))


def resnet_cifar(depth_n=3, num_classes=10, **kw):
    return ResNetCifar(depth_n, num_classes, **kw)
