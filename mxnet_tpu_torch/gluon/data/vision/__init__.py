"""Vision datasets and transforms (the counterpart of
`mxnet_tpu/gluon/data/vision`)."""
from . import transforms
from .datasets import CIFAR10, CIFAR100, MNIST, FashionMNIST

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100", "transforms"]
