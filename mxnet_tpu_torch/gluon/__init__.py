"""Gluon: the imperative and hybrid network API (the counterpart of
`mxnet_tpu/gluon`; reference `python/mxnet/gluon/`), with the
experimental layers and cells of `contrib`."""
from . import parameter
from .parameter import Constant, Parameter, ParameterDict
from . import block
from .block import Block, HybridBlock, SymbolBlock
from . import nn
from . import rnn
from . import loss
from . import data
from .trainer import Trainer
from . import model_zoo
from . import contrib
from . import utils

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter", "Constant",
           "ParameterDict", "Trainer", "nn", "rnn", "loss", "data",
           "model_zoo", "contrib", "utils", "parameter", "block"]
