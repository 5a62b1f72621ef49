"""Optimizer package (the counterpart of `mxnet_tpu/optimizer`)."""
from .optimizer import (SGD, AdaGrad, Adam, Optimizer, Updater, create,
                        get_updater, register)

__all__ = ["Optimizer", "SGD", "Adam", "AdaGrad", "Updater", "create",
           "get_updater", "register"]
