"""Testing toolkit (the counterpart of `mxnet_tpu/test_utils.py`; reference
`python/mxnet/test_utils.py`), over the port's `nd` and `sym`.

The two load-bearing oracles from the reference's suite:
`check_numeric_gradient` (finite differences against the executor's
backward) and `check_consistency` (one graph on every context of a
``ctx_list``, optimized program against the composed graph, as the
reference ran one symbol on the CPU and the GPU).  Plus dtype-aware
`assert_almost_equal` and the symbolic forward/backward checkers.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from . import ndarray as nd
from .base import MXNetError
from .context import cpu, current_context
from .ndarray.ndarray import NDArray

__all__ = ["assert_almost_equal", "almost_equal", "same", "default_context",
           "rand_ndarray", "rand_shape_nd", "check_numeric_gradient",
           "check_symbolic_forward", "check_symbolic_backward",
           "check_consistency", "simple_forward", "numeric_grad"]

_DTYPE_TOL = {
    np.dtype(np.float16): (1e-2, 1e-2),
    np.dtype(np.float32): (1e-4, 1e-5),
    np.dtype(np.float64): (1e-6, 1e-8),
}


def default_context():
    return current_context()


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return np.asarray(x)


def same(a, b):
    return np.array_equal(_as_np(a), _as_np(b))


def almost_equal(a, b, rtol=None, atol=None):
    a, b = _as_np(a), _as_np(b)
    rtol, atol = _tols(a, b, rtol, atol)
    return np.allclose(a, b, rtol=rtol, atol=atol)


def _tols(a, b, rtol, atol):
    if rtol is None or atol is None:
        dt = np.promote_types(a.dtype, b.dtype)
        r, t = _DTYPE_TOL.get(np.dtype(dt), (1e-5, 1e-7))
        rtol = rtol if rtol is not None else r
        atol = atol if atol is not None else t
    return rtol, atol


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    """Dtype-aware tolerance comparison (reference
    `test_utils.py:assert_almost_equal`)."""
    a_np, b_np = _as_np(a), _as_np(b)
    rtol, atol = _tols(a_np, b_np, rtol, atol)
    np.testing.assert_allclose(a_np, b_np, rtol=rtol, atol=atol,
                               err_msg=f"{names[0]} != {names[1]}")


def rand_shape_nd(ndim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=ndim))


def rand_ndarray(shape, stype="default", density=None, dtype=None, ctx=None):
    arr = np.random.uniform(-1.0, 1.0, size=shape)
    return nd.array(arr, ctx=ctx, dtype=dtype or np.float32)


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    """Run a symbol on given inputs, return numpy outputs."""
    shapes = {k: np.asarray(v).shape for k, v in inputs.items()}
    ex = sym.simple_bind(ctx=ctx, grad_req="null", **shapes)
    outs = ex.forward(is_train=is_train,
                      **{k: np.asarray(v, np.float32) for k, v in inputs.items()})
    outs = [o.asnumpy() for o in outs]
    return outs[0] if len(outs) == 1 else outs


def numeric_grad(f: Callable[[np.ndarray], float], x: np.ndarray,
                 eps=1e-4) -> np.ndarray:
    """Central finite differences (reference `test_utils.py:numeric_grad`)."""
    grad = np.zeros_like(x, dtype=np.float64)
    it = np.nditer(x, flags=["multi_index"])
    while not it.finished:
        idx = it.multi_index
        orig = x[idx]
        x[idx] = orig + eps
        fp = f(x)
        x[idx] = orig - eps
        fm = f(x)
        x[idx] = orig
        grad[idx] = (fp - fm) / (2 * eps)
        it.iternext()
    return grad


def check_numeric_gradient(sym, location, aux_states=None,
                           numeric_eps=1e-3, rtol=1e-2, atol=None,
                           grad_nodes=None, ctx=None):
    """Finite differences vs the executor's backward (reference
    `test_utils.py:check_numeric_gradient` — oracle #1 of the suite)."""
    location = _normalize_loc(sym, location)
    grad_nodes = grad_nodes or [k for k in location]
    shapes = {k: v.shape for k, v in location.items()}
    ex = sym.simple_bind(ctx=ctx, grad_req="write", **shapes)
    for k, v in location.items():
        ex.arg_dict[k][:] = v
    if aux_states:
        for k, v in aux_states.items():
            ex.aux_dict[k][:] = v
    out = ex.forward(is_train=True, **location)
    # random fixed projection so multi-dim outputs reduce to a scalar
    rng = np.random.RandomState(0)
    proj = [rng.normal(0, 1.0, size=o.shape).astype(np.float64) for o in out]
    ex.backward([nd.array(p.astype(np.float32)) for p in proj])

    for name in grad_nodes:
        analytic = ex.grad_dict[name].asnumpy().astype(np.float64)

        def f(x, _name=name):
            loc = {k: (x if k == _name else v) for k, v in location.items()}
            ex2 = sym.simple_bind(ctx=ctx, grad_req="null", **shapes)
            if aux_states:
                for k, v in aux_states.items():
                    ex2.aux_dict[k][:] = v
            outs = ex2.forward(is_train=True,
                               **{k: np.asarray(v, np.float32)
                                  for k, v in loc.items()})
            return float(sum((o.asnumpy().astype(np.float64) * p).sum()
                             for o, p in zip(outs, proj)))

        numeric = numeric_grad(f, location[name].astype(np.float64),
                               eps=numeric_eps)
        np.testing.assert_allclose(
            analytic, numeric, rtol=rtol, atol=atol or 1e-3,
            err_msg=f"gradient mismatch for {name}")


def check_symbolic_forward(sym, location, expected, rtol=1e-5, atol=1e-6,
                           aux_states=None, ctx=None, is_train=False):
    """Outputs vs numpy reference (reference
    `test_utils.py:check_symbolic_forward`)."""
    location = _normalize_loc(sym, location)
    shapes = {k: v.shape for k, v in location.items()}
    ex = sym.simple_bind(ctx=ctx, grad_req="null", **shapes)
    if aux_states:
        for k, v in aux_states.items():
            ex.aux_dict[k][:] = v
    outs = ex.forward(is_train=is_train,
                      **{k: np.asarray(v, np.float32)
                         for k, v in location.items()})
    expected = expected if isinstance(expected, (list, tuple)) else [expected]
    for o, e in zip(outs, expected):
        assert_almost_equal(o, e, rtol, atol)
    return [o.asnumpy() for o in outs]


def check_symbolic_backward(sym, location, out_grads, expected,
                            rtol=1e-5, atol=1e-6, aux_states=None,
                            grad_req="write", ctx=None):
    """Input grads vs numpy reference (reference
    `test_utils.py:check_symbolic_backward`)."""
    location = _normalize_loc(sym, location)
    shapes = {k: v.shape for k, v in location.items()}
    ex = sym.simple_bind(ctx=ctx, grad_req=grad_req, **shapes)
    if aux_states:
        for k, v in aux_states.items():
            ex.aux_dict[k][:] = v
    ex.forward(is_train=True, **{k: np.asarray(v, np.float32)
                                 for k, v in location.items()})
    ex.backward([nd.array(np.asarray(g, np.float32)) for g in out_grads])
    if isinstance(expected, dict):
        items = expected.items()
    else:
        items = zip(sym.list_arguments(), expected)
    for name, e in items:
        if e is None:
            continue
        assert_almost_equal(ex.grad_dict[name], e, rtol, atol,
                            names=(f"grad({name})", "expected"))
    return {k: v.asnumpy() for k, v in ex.grad_dict.items()}


def _ctx_entries(ctx_list):
    """``ctx_list`` as (Context, shape overrides) pairs: an entry is a
    Context or the reference's dict (``{'ctx': ..., name: shape, ...,
    'type_dict': ...}``); None means the CPU and every CUDA device."""
    from .context import Context, gpu
    if ctx_list is None:
        ctx_list = [cpu()] + [gpu(i) for i in list_gpus()]
    out = []
    for entry in ctx_list:
        if isinstance(entry, Context):
            out.append((entry, {}))
        else:
            shapes = {k: tuple(v) for k, v in entry.items()
                      if k not in ("ctx", "type_dict")}
            out.append((entry["ctx"], shapes))
    return out


def check_consistency(sym, ctx_list=None, scale=1.0, grad_req="write",
                      arg_params=None, tol=None):
    """Cross-device oracle (reference `test_utils.py:check_consistency`
    runs one symbol on cpu/gpu/fp16 and compares).  Here the same seeded
    inputs run on every context of ``ctx_list``, each through its
    optimized `GraphProgram` (captured on a CUDA device) and through the
    composed graph op by op; every output must agree with the first
    context's program within ``tol``.  Returns the first context's
    outputs."""
    if isinstance(sym, (list, tuple)):
        sym = sym[0]
    entries = _ctx_entries(ctx_list)
    if not entries:
        raise MXNetError("check_consistency needs at least one context")
    arg_names = sym.list_arguments()
    shapes = {k: v.shape for k, v in (arg_params or {}).items()}
    shapes.update(entries[0][1])
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(0)
    feed = {}
    for name, shape in zip(arg_names, arg_shapes):
        if arg_params and name in arg_params:
            feed[name] = np.asarray(arg_params[name], np.float32)
        else:
            feed[name] = rng.normal(0, scale, size=shape).astype(np.float32)
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        feed[name] = np.zeros(shape, np.float32)

    aux_names = sym.list_auxiliary_states()
    first = None
    for ctx, _shapes in entries:
        args = {n: nd.array(feed[n], ctx=ctx) for n in arg_names}
        aux = {n: nd.array(feed[n], ctx=ctx) for n in aux_names}
        ex = sym.bind(ctx, args=args, aux_states=aux, grad_req="null")
        compiled = [o.asnumpy() for o in ex.compiled_forward(is_train=False)]
        composed = [o.asnumpy() for o in ex.forward(is_train=False)]
        for c, i in zip(compiled, composed):
            assert_almost_equal(c, i, rtol=(tol or 1e-5), atol=(tol or 1e-6),
                                names=(f"compiled on {ctx}",
                                       f"composed on {ctx}"))
        if first is None:
            first = (ctx, compiled)
            continue
        for c, f in zip(compiled, first[1]):
            assert_almost_equal(c, f, rtol=(tol or 1e-5), atol=(tol or 1e-6),
                                names=(str(ctx), str(first[0])))
    return first[1]


def _normalize_loc(sym, location) -> Dict[str, np.ndarray]:
    if isinstance(location, dict):
        return {k: np.asarray(v, np.float64) for k, v in location.items()}
    return {n: np.asarray(v, np.float64)
            for n, v in zip(sym.list_arguments(), location)}


# ---------------------------------------------------------------------------
# data + environment helpers (reference test_utils.py:list_gpus..compare_optimizer)
# ---------------------------------------------------------------------------

def set_default_context(ctx):
    """Reference `set_default_context` -- switch the thread default."""
    from .context import _SCOPE
    _SCOPE.value = ctx


def default_dtype():
    return np.float32


def list_gpus():
    """Indices of the CUDA devices (reference `list_gpus`)."""
    import torch
    return list(range(torch.cuda.device_count())) \
        if torch.cuda.is_available() else []


def list_tpus():
    """Indices of TPU devices: none, the port runs on CUDA devices."""
    return []


def download(url, fname=None, dirname=None, overwrite=False):
    """Reference `download`.  This environment has no egress: local
    `file://` paths and already-present files work; anything else raises
    with a clear message instead of hanging."""
    import os
    import shutil
    fname = fname or url.split("/")[-1]
    if dirname:
        os.makedirs(dirname, exist_ok=True)
        fname = os.path.join(dirname, fname)
    if os.path.exists(fname) and not overwrite:
        return fname
    if url.startswith("file://"):
        shutil.copyfile(url[len("file://"):], fname)
        return fname
    if os.path.exists(url):
        shutil.copyfile(url, fname)
        return fname
    raise MXNetError(
        f"download({url!r}): no network egress in this environment; "
        "place the file locally and pass its path")


def get_mnist():
    """Reference `get_mnist`: dict of train/test arrays.  Without network
    access the data is the deterministic synthetic MNIST of the JAX
    package (one shared recipe, `datasets.synthetic_mnist_arrays`)."""
    from .gluon.data.vision.datasets import synthetic_mnist_arrays
    img, lbl = synthetic_mnist_arrays()
    n_train = len(img) * 3 // 4
    return {"train_data": img[:n_train], "train_label": lbl[:n_train],
            "test_data": img[n_train:], "test_label": lbl[n_train:]}


def get_mnist_iterator(batch_size, input_shape, num_parts=1, part_index=0):
    """Reference `get_mnist_iterator`: (train_iter, val_iter)."""
    from .io import NDArrayIter
    mnist = get_mnist()

    def reshape(x):
        return x.reshape((x.shape[0],) + tuple(input_shape))

    train = NDArrayIter(reshape(mnist["train_data"]), mnist["train_label"],
                        batch_size, shuffle=True, num_parts=num_parts,
                        part_index=part_index)
    val = NDArrayIter(reshape(mnist["test_data"]), mnist["test_label"],
                      batch_size, num_parts=num_parts,
                      part_index=part_index)
    return train, val


def rand_sparse_ndarray(shape, stype, density=None, dtype=None,
                        rng=None):
    """Reference `rand_sparse_ndarray`: (sparse NDArray, dense np array).
    Draws from the live numpy state (pass `rng` to pin)."""
    from .ndarray import sparse as _sp
    density = 0.1 if density is None else density
    dtype = np.float32 if dtype is None else dtype
    rng = rng or np.random
    dense = (rng.rand(*shape) < density) * rng.randn(*shape)
    dense = dense.astype(dtype)
    if stype == "row_sparse":
        arr = _sp.row_sparse_array(dense)
    elif stype == "csr":
        arr = _sp.csr_matrix(dense)
    else:
        raise MXNetError(f"unknown stype {stype!r}")
    return arr, dense


def compare_optimizer(opt1, opt2, shape, dtype="float32", w_stype=None,
                      g_stype=None, rtol=1e-4, atol=1e-5, ntests=3):
    """Reference `compare_optimizer`: two optimizers must produce the same
    trajectory from the same start; `w_stype`/`g_stype` exercise the
    sparse update paths (row_sparse/csr)."""
    from .ndarray import ndarray as _nd

    def as_stype(arr, stype):
        return arr if stype in (None, "default") else arr.tostype(stype)

    rng = np.random.RandomState(0)
    w_np = rng.randn(*shape).astype(dtype)
    w1 = as_stype(_nd.array(w_np), w_stype)
    w2 = as_stype(_nd.array(w_np), w_stype)
    s1 = opt1.create_state_multi_precision(0, w1)
    s2 = opt2.create_state_multi_precision(0, w2)
    for _ in range(ntests):
        g_np = rng.randn(*shape).astype(dtype)
        # sparse grads: zero some rows so the stype is meaningful
        if g_stype not in (None, "default"):
            g_np[:: 2] = 0
        g1 = as_stype(_nd.array(g_np), g_stype)
        g2 = as_stype(_nd.array(g_np), g_stype)
        opt1.update_multi_precision(0, w1, g1, s1)
        opt2.update_multi_precision(0, w2, g2, s2)
        assert_almost_equal(w1.asnumpy(), w2.asnumpy(), rtol=rtol,
                            atol=atol, names=("opt1", "opt2"))


def same_array(a, b):
    """Reference `same_array`: does writing one NDArray show through the
    other?  Two arrays alias when their tensors share storage (a view
    writes through to its base, as the reference's do)."""
    if a is b:
        return True
    ta, tb = a.data, b.data
    return ta.device == tb.device and \
        ta.untyped_storage().data_ptr() == tb.untyped_storage().data_ptr()


def check_speed(sym=None, location=None, ctx=None, N=20, grad_req="write",
                typ="whole"):
    """Reference `check_speed`: seconds per forward(+backward) pass of a
    bound symbol.  `typ='whole'` times fwd+bwd, `'forward'` fwd only."""
    import time as _time
    if typ not in ("whole", "forward"):
        raise MXNetError('typ can only be "whole" or "forward"')
    if location is None:
        raise MXNetError("check_speed needs location={name: np.ndarray}")
    loc = {k: np.asarray(v, np.float32) for k, v in location.items()}
    ex = sym.simple_bind(ctx=ctx, grad_req=grad_req,
                         **{k: v.shape for k, v in loc.items()})
    # feed once OUTSIDE the timed loop (reference check_speed does the
    # same) so the measurement is the op, not host->device copies
    for k, v in loc.items():
        ex.arg_dict[k][:] = v

    def run_once():
        ex.forward(is_train=(typ == "whole"))
        if typ == "whole":
            ex.backward()
            for g in ex.grad_arrays:
                if g is not None:
                    g.wait_to_read()
        else:
            for o in ex.outputs:
                o.wait_to_read()

    run_once()  # build the program (and its capture on the card)
    tic = _time.time()
    for _ in range(N):
        run_once()
    return (_time.time() - tic) / N


# ---------------------------------------------------------------------------
# additional reference-parity helpers (`python/mxnet/test_utils.py`):
# shape/array generators, NaN-tolerant comparison, env management,
# distribution checks, dataset fetch contracts.
# ---------------------------------------------------------------------------

def get_rtol(rtol=None):
    """Default relative tolerance if none given (reference `get_rtol`)."""
    return 1e-5 if rtol is None else rtol


def get_atol(atol=None):
    """Default absolute tolerance if none given (reference `get_atol`)."""
    return 1e-20 if atol is None else atol


def random_arrays(*shapes):
    """List of float64 standard-normal arrays, one per shape; a scalar
    shape () yields a python float-like 0-d array."""
    arrays = [np.random.randn(*s).astype(np.float64)
              if s else np.asarray(np.random.randn()) for s in shapes]
    return arrays[0] if len(arrays) == 1 else arrays


def random_sample(population, k):
    """k samples WITHOUT replacement, order preserved by sample draw."""
    import random as _random
    return _random.sample(population, k)


def rand_shape_2d(dim0=10, dim1=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1),
            np.random.randint(1, dim2 + 1))


def np_reduce(dat, axis, keepdims, numpy_reduce_func):
    """Reference `np_reduce`: apply a numpy reduction with MXNet axis
    semantics (None/int/tuple, keepdims re-expansion)."""
    if isinstance(axis, int):
        axis = [axis]
    else:
        axis = list(axis) if axis is not None else range(len(dat.shape))
    ret = dat
    for i in reversed(sorted(axis)):
        ret = numpy_reduce_func(ret, axis=i)
    if keepdims:
        keepdims_shape = list(dat.shape)
        for i in axis:
            keepdims_shape[i] = 1
        ret = ret.reshape(tuple(keepdims_shape))
    return ret


def find_max_violation(a, b, rtol=None, atol=None):
    """Location and value of the maximum relative-error violation."""
    a, b = _as_np(a), _as_np(b)
    rtol, atol = get_rtol(rtol), get_atol(atol)
    diff = np.abs(a - b)
    tol = atol + rtol * np.abs(b)
    violation = diff / (tol + 1e-300)
    loc = np.unravel_index(np.argmax(violation), violation.shape) \
        if violation.shape else ()
    return loc, float(violation[loc] if violation.shape else violation)


def almost_equal_ignore_nan(a, b, rtol=None, atol=None):
    """Elementwise comparison skipping positions where EITHER side is NaN."""
    a, b = _as_np(a).copy(), _as_np(b).copy()
    nan_mask = np.logical_or(np.isnan(a), np.isnan(b))
    a[nan_mask] = 0
    b[nan_mask] = 0
    return np.allclose(a, b, rtol=get_rtol(rtol), atol=get_atol(atol))


def assert_almost_equal_ignore_nan(a, b, rtol=None, atol=None,
                                   names=("a", "b")):
    a_np, b_np = _as_np(a).copy(), _as_np(b).copy()
    nan_mask = np.logical_or(np.isnan(a_np), np.isnan(b_np))
    a_np[nan_mask] = 0
    b_np[nan_mask] = 0
    assert_almost_equal(a_np, b_np, rtol=rtol, atol=atol, names=names)


def assert_exception(f, exception_type, *args, **kwargs):
    """Assert that calling f raises exception_type."""
    try:
        f(*args, **kwargs)
    except exception_type:
        return
    raise AssertionError(f"{f} did not raise {exception_type}")


def assign_each(input_arr, function):
    """Apply a scalar function elementwise (vectorized) to one array."""
    return (np.vectorize(function)(input_arr).astype(input_arr.dtype)
            if function is not None else np.array(input_arr))


def assign_each2(input1, input2, function):
    """Apply a binary scalar function elementwise over two arrays."""
    return (np.vectorize(function)(input1, input2).astype(input1.dtype)
            if function is not None else np.array(input1))


def compare_ndarray_tuple(t1, t2, rtol=None, atol=None):
    """Compare (possibly nested) tuples of ndarrays elementwise."""
    if t1 is None or t2 is None:
        return
    if isinstance(t1, tuple):
        for s1, s2 in zip(t1, t2):
            compare_ndarray_tuple(s1, s2, rtol, atol)
    else:
        assert_almost_equal(t1, t2, rtol=rtol, atol=atol)


class DummyIter:
    """Data iterator that caches the real iterator's first batch and
    returns it forever — isolates IO cost from compute when benchmarking
    (reference `test_utils.py:DummyIter`)."""

    def __init__(self, real_iter):
        self.real_iter = real_iter
        self.provide_data = real_iter.provide_data
        self.provide_label = real_iter.provide_label
        self.batch_size = real_iter.batch_size
        self.the_batch = next(real_iter)

    def __iter__(self):
        return self

    def next(self):
        return self.the_batch

    __next__ = next

    def reset(self):
        pass


class EnvManager:
    """Context manager scoping one os.environ key (reference
    `test_utils.py:EnvManager`)."""

    def __init__(self, key, val):
        self._key = key
        self._next_val = val
        self._prev_val = None

    def __enter__(self):
        import os
        # mxtpu-lint: disable=raw-env-read -- env-scoping context
        # manager; the key is the caller's, not a knob read
        self._prev_val = os.environ.get(self._key)
        os.environ[self._key] = self._next_val

    def __exit__(self, ptype, value, trace):
        import os
        if self._prev_val is None:
            del os.environ[self._key]
        else:
            os.environ[self._key] = self._prev_val


def set_env_var(key, val, default_val=""):
    """Set environment variable, returning its previous value."""
    import os
    # mxtpu-lint: disable=raw-env-read -- env-scoping helper; the key
    # is the caller's, not a knob read
    prev_val = os.environ.get(key, default_val)
    os.environ[key] = val
    return prev_val


def discard_stderr():
    """Context manager discarding stderr (noisy-op tests)."""
    import contextlib
    import os
    import sys

    @contextlib.contextmanager
    def _ctx():
        with open(os.devnull, 'w') as bit_bucket:
            old = sys.stderr
            sys.stderr = bit_bucket
            try:
                yield
            finally:
                sys.stderr = old
    return _ctx()


def retry(n):
    """Decorator: retry a flaky (random) test up to n times (reference
    `test_utils.py:retry`)."""
    if n <= 0:
        raise ValueError('Please use a positive integer')
    import functools

    def decorate(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            for i in range(n):
                try:
                    return f(*args, **kwargs)
                except AssertionError as e:
                    if i == n - 1:
                        raise e
        return wrapper
    return decorate


def shuffle_csr_column_indices(csr):
    """Shuffle the column indices within each row of a scipy-like CSR
    (tests unordered-index tolerance)."""
    import numpy as _np
    row_count = len(csr.indptr) - 1
    for i in range(row_count):
        start, end = csr.indptr[i], csr.indptr[i + 1]
        sub = csr.indices[start:end]
        _np.random.shuffle(sub)
        csr.indices[start:end] = sub
    return csr


def create_sparse_array(shape, stype, data_init=None, rsp_indices=None,
                        dtype=None, modifier_func=None, density=0.5,
                        shuffle_csr_indices=False):
    """Build a sparse NDArray with optional fixed fill / index sets
    (reference `test_utils.py:create_sparse_array`)."""
    if stype == 'row_sparse':
        if rsp_indices is not None:
            num_rows = shape[0]
            arr = np.zeros(shape, dtype=dtype or np.float32)
            idx = np.asarray(sorted(set(int(i) for i in rsp_indices)),
                             dtype=np.int64)
            idx = idx[idx < num_rows]
            for i in idx:
                arr[i] = (data_init if data_init is not None
                          else np.random.uniform(0, 1, shape[1:]))
            res = nd.sparse.row_sparse_array(
                (nd.array(arr[idx]), nd.array(idx)), shape=shape)
        else:
            res, _ = rand_sparse_ndarray(shape, stype, density=density,
                                         dtype=dtype)
    elif stype == 'csr':
        res, _ = rand_sparse_ndarray(shape, stype, density=density,
                                     dtype=dtype)
        if shuffle_csr_indices:
            import scipy.sparse as sps
            sp = sps.csr_matrix(res.asnumpy())
            sp = shuffle_csr_column_indices(sp)
            res = nd.sparse.csr_matrix(
                (sp.data, sp.indices, sp.indptr), shape=shape)
    else:
        raise MXNetError(f"unknown sparse type {stype}")
    if data_init is not None and rsp_indices is None:
        dense = np.array(res.tostype('default').asnumpy())
        dense[dense != 0] = data_init
        res = nd.array(dense).tostype(stype)
    if modifier_func is not None:
        dense = np.array(res.tostype('default').asnumpy())
        dense = assign_each(dense, modifier_func)
        res = nd.array(dense).tostype(stype)
    return res


def create_sparse_array_zd(shape, stype, density, data_init=None,
                           rsp_indices=None, dtype=None, modifier_func=None,
                           shuffle_csr_indices=False):
    """Sparse array generator biased toward zero-density corner cases."""
    if density == 0 and stype == 'row_sparse':
        rsp_indices = np.array([], dtype='int64')
    return create_sparse_array(shape, stype, data_init=data_init,
                               rsp_indices=rsp_indices, dtype=dtype,
                               modifier_func=modifier_func, density=density,
                               shuffle_csr_indices=shuffle_csr_indices)


def mean_check(generator, mu, sigma, nsamples=1000000):
    """Z-test that `generator` draws have mean mu (reference
    `test_utils.py:mean_check`)."""
    samples = np.array(generator(nsamples))
    sample_mean = samples.mean()
    ret = (sample_mean > mu - 3 * sigma / np.sqrt(nsamples)) and \
          (sample_mean < mu + 3 * sigma / np.sqrt(nsamples))
    return ret


def var_check(generator, sigma, nsamples=1000000):
    """Chi-square-style variance check for a sample generator."""
    samples = np.array(generator(nsamples))
    sample_var = samples.var(ddof=1)
    ret = (sample_var > sigma ** 2 * (1 - 3 * np.sqrt(2.0 / (nsamples - 1))))\
        and (sample_var < sigma ** 2 * (1 + 3 * np.sqrt(2.0 / (nsamples - 1))))
    return ret


def gen_buckets_probs_with_ppf(ppf, nbuckets):
    """Quantile buckets + per-bucket probability from a percent-point
    function (for chi-square generator checks)."""
    probs = [1.0 / nbuckets] * nbuckets
    buckets = [(ppf(i / float(nbuckets)), ppf((i + 1) / float(nbuckets)))
               for i in range(nbuckets)]
    return buckets, probs


def chi_square_check(generator, buckets, probs, nsamples=1000000):
    """Chi-square goodness-of-fit of generator draws against bucket
    probabilities; returns (statistic, p-value) like the reference."""
    import scipy.stats as ss
    if not buckets:
        raise MXNetError("buckets cannot be empty")
    expected = np.array(probs, dtype=np.float64) * nsamples
    if isinstance(buckets[0], (list, tuple)):
        samples = np.asarray(generator(nsamples))
        counts = np.zeros(len(buckets))
        for i, (lo, hi) in enumerate(buckets):
            counts[i] = ((samples >= lo) & (samples < hi)).sum()
    else:
        samples = list(generator(nsamples))
        import collections
        cnt = collections.Counter(samples)
        counts = np.array([cnt.get(b, 0) for b in buckets], np.float64)
    statistic, pvalue = ss.chisquare(f_obs=counts, f_exp=expected)
    return statistic, pvalue


def verify_generator(generator, buckets, probs, nsamples=1000000,
                     nrepeat=5, success_rate=0.2, alpha=0.05):
    """Repeat chi-square checks; succeed if enough repeats pass
    (reference `test_utils.py:verify_generator`)."""
    cs_ret_l = []
    for _ in range(nrepeat):
        statistic, pvalue = chi_square_check(generator, buckets, probs,
                                             nsamples)
        cs_ret_l.append(pvalue)
    success_num = (np.array(cs_ret_l) > alpha).sum()
    if success_num < nrepeat * success_rate:
        raise AssertionError(
            f"Generator test fails, Chi-square p={cs_ret_l} "
            f"successes={success_num}/{nrepeat}")
    return cs_ret_l


def get_im2rec_path(home_env="MXNET_HOME"):
    """Path to the im2rec tool (the repository's `tools/im2rec.py`)."""
    import os
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "im2rec.py")


def get_mnist_pkl(data_dir="data"):
    """Download mnist.pkl.gz into data_dir (reference contract; this
    environment has no egress, so it raises unless already present)."""
    import os
    path = os.path.join(data_dir, "mnist.pkl.gz")
    if not os.path.isfile(path):
        os.makedirs(data_dir, exist_ok=True)
        download("http://deeplearning.net/data/mnist/mnist.pkl.gz",
                 dirname=data_dir)
    return path


def get_mnist_ubyte(data_dir="data"):
    """Ensure the ubyte MNIST files exist in data_dir (download contract)."""
    import os
    files = ['train-images-idx3-ubyte', 'train-labels-idx1-ubyte',
             't10k-images-idx3-ubyte', 't10k-labels-idx1-ubyte']
    if not all(os.path.isfile(os.path.join(data_dir, f)) for f in files):
        raise MXNetError("MNIST ubyte files missing and this environment "
                         f"has no network egress; place {files} under "
                         f"{data_dir} (or use test_utils.get_mnist() for "
                         "the synthetic recipe)")
    return data_dir


def get_cifar10(data_dir="data"):
    """Ensure CIFAR-10 RecordIO files exist (download contract; no-egress
    environments must pre-seed them)."""
    import os
    files = ['cifar/train.rec', 'cifar/test.rec', 'cifar/train.lst',
             'cifar/test.lst']
    if not all(os.path.isfile(os.path.join(data_dir, f)) for f in files):
        raise MXNetError("CIFAR-10 rec files missing and this environment "
                         f"has no network egress; place {files} under "
                         f"{data_dir}")
    return data_dir


def get_bz2_data(data_dir, data_name, url, data_origin_name):
    """Download + decompress a bz2 dataset (reference contract)."""
    import bz2
    import os
    path = os.path.join(data_dir, data_name)
    if not os.path.isfile(path):
        origin = download(url, dirname=data_dir)
        with bz2.BZ2File(origin) as fin, open(path, 'wb') as fout:
            fout.write(fin.read())
        os.remove(origin)
    return path


def get_zip_data(data_dir, url, data_origin_name):
    """Download + unzip a dataset archive (reference contract)."""
    import os
    import zipfile
    origin = os.path.join(data_dir, data_origin_name)
    if not os.path.isfile(origin):
        download(url, fname=origin, dirname=data_dir)
    with zipfile.ZipFile(origin) as zf:
        zf.extractall(data_dir)
