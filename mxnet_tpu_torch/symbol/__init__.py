"""`mx.sym`: graph construction plus one composer per registered op, the
`random` and `linalg` namespaces, and the fluent methods (``s.sum()``,
``s.reshape(shape=...)``, ...) attached to `Symbol`."""
from .. import ops as _ops  # noqa: F401  (registers the ops)
from ..base import InternalNamespace
from .register import invoke_sym, make_sym_functions
from .symbol import (Group, Symbol, Variable, load, load_json,
                     name_prefix_scope, var)
from . import linalg, random, tracer  # noqa: E402

make_sym_functions(globals())


_internal = InternalNamespace(globals(), __name__)


def concat_nd(symbols, axis=0, name=None):
    """``Concat`` of a list of Symbols along ``axis``, the symbol front's
    form of `nd.concat_nd` (a HybridBlock's ``F.concat_nd``)."""
    return invoke_sym("Concat", *symbols, name=name, dim=axis,
                      num_args=len(symbols))


def zeros(shape, dtype=None, name=None):
    return invoke_sym("_zeros", name=name, shape=shape,
                      dtype=dtype or "float32")


def ones(shape, dtype=None, name=None):
    return invoke_sym("_ones", name=name, shape=shape,
                      dtype=dtype or "float32")


def full(shape, val, name=None, dtype=None):
    return invoke_sym("_full", name=name, shape=shape, value=float(val),
                      dtype=dtype or "float32")


def arange(start, stop=None, step=1.0, repeat=1, name=None, dtype=None):
    return invoke_sym("_arange", name=name, start=start, stop=stop,
                      step=step, repeat=repeat, dtype=dtype or "float32")


def eye(N, M=0, k=0, name=None, dtype=None):
    return invoke_sym("_eye", name=name, N=N, M=M, k=k,
                      dtype=dtype or "float32")


def hypot(left, right, name=None):
    """sqrt(left^2 + right^2) with broadcasting."""
    return invoke_sym("broadcast_hypot", left, right, name=name)


def split_v2(data, indices_or_sections, axis=0, squeeze_axis=False,
             name=None):
    """Split ``data`` along ``axis``: an int is that many equal sections,
    a tuple the split points."""
    if isinstance(indices_or_sections, int):
        return invoke_sym("_split_v2", data, name=name,
                          sections=indices_or_sections, axis=axis,
                          squeeze_axis=squeeze_axis)
    return invoke_sym("_split_v2", data, name=name,
                      indices=tuple(indices_or_sections), axis=axis,
                      squeeze_axis=squeeze_axis)


#: ops attached to `Symbol` as methods (the JAX package's
#: `_SYM_FLUENT_METHODS`); a method the class defines wins
SYM_FLUENT_METHODS = (
    "abs", "arccos", "arccosh", "arcsin", "arcsinh", "arctan", "arctanh",
    "argmax", "argmax_channel", "argmin", "argsort", "broadcast_axes",
    "broadcast_like", "broadcast_to", "cbrt", "ceil", "clip", "cos",
    "cosh", "degrees", "depth_to_space", "diag", "exp", "expand_dims",
    "expm1", "fix", "flatten", "flip", "floor", "log", "log10", "log1p",
    "log2", "log_softmax", "max", "mean", "min", "nanprod", "nansum",
    "norm", "one_hot", "ones_like", "pad", "pick", "prod", "radians",
    "rcbrt", "reciprocal", "relu", "repeat", "reshape", "reshape_like",
    "rint", "round", "rsqrt", "shape_array", "sigmoid", "sign", "sin",
    "sinh", "size_array", "slice", "slice_axis", "slice_like", "softmax",
    "softmin", "sort", "space_to_depth", "split", "split_v2", "sqrt",
    "square", "squeeze", "sum", "swapaxes", "take", "tan", "tanh", "tile",
    "topk", "transpose", "trunc", "zeros_like",
)


def _sym_fluent(op_name):
    def method(self, *args, **kwargs):
        return invoke_sym(op_name, self, *args, **kwargs)
    method.__name__ = op_name
    method.__qualname__ = f"Symbol.{op_name}"
    method.__doc__ = f"``sym.{op_name}(self, ...)``."
    return method


def _sym_split_v2(self, indices_or_sections, axis=0, squeeze_axis=False):
    """``sym.split_v2(self, ...)``."""
    return split_v2(self, indices_or_sections, axis=axis,
                    squeeze_axis=squeeze_axis)


for _n in SYM_FLUENT_METHODS:
    if not hasattr(Symbol, _n):
        setattr(Symbol, _n, _sym_split_v2 if _n == "split_v2"
                else _sym_fluent(_n))


from . import sparse  # noqa: E402

__all__ = ["Symbol", "var", "Variable", "Group", "sparse", "load",
           "load_json", "invoke_sym", "concat_nd", "zeros", "ones", "full",
           "arange", "eye", "random", "linalg", "name_prefix_scope",
           "hypot", "split_v2"]
