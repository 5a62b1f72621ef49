"""`mx.nd`: NDArray creation plus one eager function per registered op."""
from .. import ops as _ops  # noqa: F401  (registers the ops)
from .ndarray import (NDArray, arange, array, empty, full, ones, waitall,
                      zeros)
from .register import invoke, make_nd_functions
from . import sparse  # noqa: E402

make_nd_functions(globals())


def concat_nd(arrays, axis=0):
    """``Concat`` of a list of NDArrays along ``axis`` (the JAX package's
    `ndarray.concat_nd`)."""
    return invoke("Concat", *arrays, dim=axis, num_args=len(arrays))


__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "waitall", "invoke", "concat_nd", "sparse"]
