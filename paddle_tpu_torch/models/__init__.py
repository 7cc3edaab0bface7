from .resnet import (BasicBlock, Bottleneck, ResNet, ResNetCifar, resnet18,
                     resnet34, resnet50, resnet101, resnet152, resnet_cifar)
from .transformer import TransformerBlock, TransformerLM

__all__ = ["BasicBlock", "Bottleneck", "ResNet", "ResNetCifar",
           "TransformerBlock", "TransformerLM", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "resnet_cifar"]
