"""`mx.sym`: graph construction plus one composer per registered op."""
from .. import ops as _ops  # noqa: F401  (registers the ops)
from .register import invoke_sym, make_sym_functions
from .symbol import Group, Symbol, Variable, load, load_json, var

make_sym_functions(globals())


class _Internal:
    """``sym._internal``: the reference's underscore-prefixed op surface
    (`sym._internal._square_sum`); the composers live on `sym` itself."""

    def __getattr__(self, name):
        fn = globals().get(name)
        if fn is None:
            raise AttributeError(f"module 'mxnet_tpu_torch.symbol._internal' "
                                 f"has no attribute {name!r}")
        return fn


_internal = _Internal()


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


from . import sparse  # noqa: E402

__all__ = ["Symbol", "var", "Variable", "Group", "sparse", "load",
           "load_json", "invoke_sym", "concat_nd", "zeros", "ones", "full",
           "arange", "eye"]
