"""Model zoo (the counterpart of `mxnet_tpu/gluon/model_zoo`): the vision
families."""
from . import vision
from .vision import get_model

__all__ = ["vision", "get_model"]
