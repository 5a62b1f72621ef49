"""Operators: importing this package registers every ported op."""
from . import registry  # noqa: F401
from . import nn, matrix, elemwise, broadcast_reduce  # noqa: F401
from . import tensor_extra, image_ops, nn_legacy  # noqa: F401
from . import optimizer_ops, rnn_op, linalg_ops, random_ops  # noqa: F401
from . import control_flow, custom_op  # noqa: F401
from . import hopper_kernels  # noqa: F401
from .. import subgraph  # noqa: F401,E402  (registers `_subgraph_op`)
