"""Optimizer package (the counterpart of `mxnet_tpu/optimizer`)."""
from .optimizer import (SGD, NAG, Adam, AdaGrad, AdaDelta, Adamax, DCASGD,
                        FTML, Ftrl, LBSGD, Nadam, Optimizer, RMSProp, SGLD,
                        Signum, Test, Updater, ccSGD, create, get_updater,
                        register)
from . import contrib
from .contrib import GroupAdaGrad

__all__ = ["Optimizer", "SGD", "ccSGD", "NAG", "Adam", "AdaGrad", "AdaDelta",
           "Adamax", "DCASGD", "FTML", "Ftrl", "LBSGD", "Nadam", "RMSProp",
           "SGLD", "Signum", "Test", "Updater", "create", "get_updater",
           "register", "contrib", "GroupAdaGrad"]
