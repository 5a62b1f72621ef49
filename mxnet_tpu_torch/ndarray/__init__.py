"""`mx.nd`: NDArray creation, one eager function per registered op, the
`random`, `linalg` and `sparse` namespaces, `save`/`load`, and the
reference's module-level helpers (the named arithmetic and comparisons,
``eye``, ``concatenate``, ``onehot_encode``, ``split_v2``)."""
from .. import ops as _ops  # noqa: F401  (registers the ops)
from ..base import InternalNamespace
from .ndarray import (NDArray, arange, array, empty, full, ones, waitall,
                      zeros)
from .register import invoke, make_nd_functions
from . import sparse  # noqa: E402
from .sparse import CSRNDArray, RowSparseNDArray  # noqa: E402
from . import linalg, random  # noqa: E402

make_nd_functions(globals())

from . import contrib, image  # noqa: E402


_internal = InternalNamespace(globals(), __name__)


def concat_nd(arrays, axis=0):
    """``Concat`` of a list of NDArrays along ``axis`` (the JAX package's
    `ndarray.concat_nd`)."""
    return invoke("Concat", *arrays, dim=axis, num_args=len(arrays))


def save(fname, data):
    """Write an NDArray, a list or a dict of them (dense or sparse) in the
    reference's ``.params`` format."""
    from ..serialization import save_ndarrays
    save_ndarrays(fname, data)


def load(fname):
    """The list or dict that `save` wrote, on the CPU."""
    from ..serialization import load_ndarrays
    return load_ndarrays(fname)


def imdecode(str_img, clip_rect=(0, 0, 0, 0), out=None, index=0,
             channels=3, mean=None):
    """An encoded image decoded (reference `ndarray.py:imdecode`, served
    by `image.imdecode`): HWC, cropped to ``clip_rect`` (x0, y0, x1, y1)
    when it is set, less ``mean`` as float32 when given, written into
    ``out`` when given."""
    from ..image import imdecode as _imdecode
    img = _imdecode(str_img, flag=1 if channels == 3 else 0)
    x0, y0, x1, y1 = clip_rect
    if x1 > 0 and y1 > 0:
        img = img[y0:y1, x0:x1]
    if mean is not None:
        img = img.astype("float32") - mean
    if out is not None:
        out[:] = img
        return out
    return img


def load_frombuffer(buf):
    """`load` from the bytes of such a file."""
    from ..serialization import loads_ndarrays
    return loads_ndarrays(buf)


def from_dlpack(tensor) -> NDArray:
    """An NDArray sharing the storage of a DLPack exporter (a tensor, or
    an object with ``__dlpack__``)."""
    import torch.utils.dlpack
    return NDArray(torch.utils.dlpack.from_dlpack(tensor))


def to_dlpack_for_read(data):
    return data.to_dlpack_for_read()


def to_dlpack_for_write(data):
    return data.to_dlpack_for_write()


# ---------------------------------------------------------------------------
# named arithmetic and comparisons: NDArray or scalar on either side,
# through the operators (reference `ndarray.py:add`, ...)
# ---------------------------------------------------------------------------

def add(lhs, rhs):
    if not isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return rhs.__radd__(lhs)
    return lhs + rhs


def subtract(lhs, rhs):
    if not isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return rhs.__rsub__(lhs)
    return lhs - rhs


def multiply(lhs, rhs):
    if not isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return rhs.__rmul__(lhs)
    return lhs * rhs


def divide(lhs, rhs):
    if not isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return rhs.__rtruediv__(lhs)
    return lhs / rhs


true_divide = divide


def modulo(lhs, rhs):
    if not isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return rhs.__rmod__(lhs)
    return lhs % rhs


def _as_nd(x, like=None):
    if isinstance(x, NDArray) or not hasattr(x, "__len__"):
        return x
    return array(x, ctx=like.context if isinstance(like, NDArray) else None)


def _compare(lhs, rhs, op, flipped):
    lhs, rhs = _as_nd(lhs, rhs), _as_nd(rhs, lhs)
    if isinstance(lhs, NDArray):
        return getattr(lhs, op)(rhs)
    return getattr(rhs, flipped)(lhs)


def equal(lhs, rhs):
    return _compare(lhs, rhs, "__eq__", "__eq__")


def not_equal(lhs, rhs):
    return _compare(lhs, rhs, "__ne__", "__ne__")


def greater(lhs, rhs):
    return _compare(lhs, rhs, "__gt__", "__lt__")


def greater_equal(lhs, rhs):
    return _compare(lhs, rhs, "__ge__", "__le__")


def lesser(lhs, rhs):
    return _compare(lhs, rhs, "__lt__", "__gt__")


def lesser_equal(lhs, rhs):
    return _compare(lhs, rhs, "__le__", "__ge__")


def _logical(lhs, rhs, op):
    lhs, rhs = _as_nd(lhs, rhs), _as_nd(rhs, lhs)
    if not isinstance(lhs, NDArray):
        lhs = full(rhs.shape, lhs, ctx=rhs.context, dtype=rhs.dtype)
    if not isinstance(rhs, NDArray):
        rhs = full(lhs.shape, rhs, ctx=lhs.context, dtype=lhs.dtype)
    return invoke(op, lhs, rhs)


def logical_and(lhs, rhs):
    return _logical(lhs, rhs, "broadcast_logical_and")


def logical_or(lhs, rhs):
    return _logical(lhs, rhs, "broadcast_logical_or")


def logical_xor(lhs, rhs):
    return _logical(lhs, rhs, "broadcast_logical_xor")


def eye(N, M=0, k=0, ctx=None, dtype=None):
    """Ones on diagonal ``k`` of an N x M matrix (M 0 means N)."""
    return invoke("_eye", N=int(N), M=int(M), k=int(k),
                  dtype=dtype or "float32", ctx=ctx)


def concatenate(arrays, axis=0, always_copy=True):
    """The legacy concatenation (reference `ndarray.py:concatenate`)."""
    if not always_copy and len(arrays) == 1:
        return arrays[0]
    return concat_nd(list(arrays), axis=axis)


def onehot_encode(indices, out):
    """One-hot rows of ``indices`` written into ``out`` (its second axis
    is the depth)."""
    res = invoke("one_hot", indices, depth=out.shape[1])
    out[:] = res.astype(out.dtype)
    return out


def split_v2(ary, indices_or_sections, axis=0, squeeze_axis=False):
    """Split ``ary`` along ``axis``: an int is that many equal sections,
    a tuple the split points."""
    if isinstance(indices_or_sections, int):
        return invoke("_split_v2", ary, sections=indices_or_sections,
                      axis=axis, squeeze_axis=squeeze_axis)
    return invoke("_split_v2", ary, indices=tuple(indices_or_sections),
                  axis=axis, squeeze_axis=squeeze_axis)


def Custom(*args, op_type=None, **kwargs):
    """A Python custom op run eagerly, on the tape under `autograd.record`
    (reference `mx.nd.Custom`; `operator.Custom`)."""
    from ..operator import Custom as _custom
    return _custom(*args, op_type=op_type, **kwargs)


__all__ = ["NDArray", "CSRNDArray", "RowSparseNDArray", "array", "zeros",
           "ones", "full", "empty", "arange", "waitall", "invoke",
           "concat_nd", "sparse", "random", "linalg", "contrib", "image",
           "save", "load",
           "load_frombuffer", "imdecode"]
