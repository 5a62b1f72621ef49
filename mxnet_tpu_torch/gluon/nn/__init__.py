"""Neural-network layers (the counterpart of `mxnet_tpu/gluon/nn`)."""
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from . import basic_layers, conv_layers  # noqa: F401
