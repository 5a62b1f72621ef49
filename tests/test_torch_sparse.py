"""The PyTorch port's sparse storage against the JAX package
(`mxnet_tpu/ndarray/sparse.py`, `mxnet_tpu/serialization.py`,
`mxnet_tpu/ops/tensor_extra.py`; cases adapted from `tests/test_sparse.py`,
`test_sparse_ndarray_cases.py`, `test_sparse_operator_cases.py` and
`test_sparse_ops_cases.py`).  The same numpy inputs go through both
packages.  Components, casts, slices, `.params` bytes and the ops that
only move values are held equal; products and sums within 1e-5 of the
JAX package's (relative, fp32 sums taken in another order)."""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import serialization as jser
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.base import MXNetError

CPU = mt.cpu()
STYPES = ["default", "csr", "row_sparse"]
RTOL = 1e-5


def _rand(shape, density=0.5, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-1, 1, shape)
            * (rs.uniform(size=shape) < density)).astype(np.float32)


def _j(arr, stype="default"):
    nd = mx.nd.array(arr)
    return nd if stype == "default" else nd.tostype(stype)


def _t(arr, stype="default"):
    nd = mt.nd.array(arr, ctx=CPU)
    return nd if stype == "default" else nd.tostype(stype)


def _components_equal(t, j):
    assert t.stype == j.stype and t.shape == j.shape
    np.testing.assert_array_equal(t.sp_data.asnumpy(),
                                  np.asarray(j._sp_data))
    np.testing.assert_array_equal(t.indices.asnumpy(),
                                  np.asarray(j._sp_indices))
    assert t.indices.dtype == np.int32           # the JAX package's dtype
    if t.stype == "csr":
        np.testing.assert_array_equal(t.indptr.asnumpy(),
                                      np.asarray(j._sp_indptr))


# ---------------------------------------------------------------------------
# the .params repair: the JAX package's sparse blobs load in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,density,seed", [
    ((5, 7), 0.3, 0), ((12, 4), 0.0, 1), ((3, 16), 1.0, 2),
    ((9, 9), 0.1, 3)])
def test_reference_sparse_params_load_and_rewrite_same_bytes(
        shape, density, seed):
    d = _rand(shape, density, seed)
    dense = np.random.RandomState(seed).rand(3, 4).astype(np.float32)
    blob = jser.dumps_ndarrays({"dense": mx.nd.array(dense),
                                "c": _j(d, "csr"),
                                "r": _j(d, "row_sparse")})
    got = tser.loads_ndarrays(blob)
    np.testing.assert_array_equal(got["dense"].asnumpy(), dense)
    _components_equal(got["c"], _j(d, "csr"))
    _components_equal(got["r"], _j(d, "row_sparse"))
    np.testing.assert_array_equal(got["c"].asnumpy(), d)
    np.testing.assert_array_equal(got["r"].asnumpy(), d)
    assert tser.dumps_ndarrays(got) == blob
    # the port's own arrays write the JAX package's bytes, and load there
    mine = {"dense": mt.nd.array(dense, ctx=CPU), "c": _t(d, "csr"),
            "r": _t(d, "row_sparse")}
    assert tser.dumps_ndarrays(mine) == blob
    back = jser.loads_ndarrays(tser.dumps_ndarrays(mine))
    assert back["c"].stype == "csr" and back["r"].stype == "row_sparse"


def test_sparse_params_file_with_footer_and_truncation(tmp_path):
    d = _rand((6, 5), 0.4, 4)
    f = str(tmp_path / "s.params")
    jser.save_ndarrays(f, {"c": _j(d, "csr"), "r": _j(d, "row_sparse")})
    got = tser.load_ndarrays(f)
    np.testing.assert_array_equal(got["c"].asnumpy(), d)
    raw = jser.dumps_ndarrays({"c": _j(d, "csr"), "r": _j(d, "row_sparse")})
    for cut in (30, 60, len(raw) // 2, len(raw) - 9):
        with pytest.raises(MXNetError, match="truncated NDArray file"):
            tser.loads_ndarrays(raw[:cut])
        with pytest.raises(mx.base.MXNetError, match="truncated"):
            jser.loads_ndarrays(raw[:cut])


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def test_create_csr_forms_match_reference():
    data, indices, indptr = [1.0, 2.0, 3.0], [0, 2, 1], [0, 2, 2, 3]
    forms = [
        lambda m, **k: m.nd.sparse.csr_matrix((data, indices, indptr), **k),
        lambda m, **k: m.nd.sparse.csr_matrix((data, indices, indptr),
                                              shape=(3, 5), **k),
        lambda m, **k: m.nd.sparse.csr_matrix(
            (data, ([0, 0, 2], [0, 2, 1])), shape=(3, 4), **k),
        lambda m, **k: m.nd.sparse.csr_matrix((3, 4), **k),
        lambda m, **k: m.nd.sparse.csr_matrix(
            np.array([[0, 1.5], [2, 0]], np.float32), **k),
    ]
    for form in forms:
        _components_equal(form(mt, ctx=CPU), form(mx))
    import scipy.sparse as spsp
    sp = spsp.csr_matrix(np.array([[0, 0, 1.0], [2.0, 0, 0]]))
    _components_equal(mt.nd.array(sp, ctx=CPU), mx.nd.array(sp))
    _components_equal(mt.nd.sparse.array(sp, ctx=CPU, dtype="float32"),
                      mx.nd.sparse.array(sp, dtype="float32"))


def test_create_csr_from_scipy_canonicalizes_without_mutation():
    import scipy.sparse as spsp
    sp = spsp.csr_matrix((np.array([1.0, 2.0, 3.0]),
                          np.array([2, 0, 2]), np.array([0, 3])),
                         shape=(1, 3))
    before = sp.indices.copy()
    t = mt.nd.sparse.csr_matrix(sp, ctx=CPU)
    _components_equal(t, mx.nd.sparse.csr_matrix(sp))
    t.check_format()
    np.testing.assert_array_equal(sp.indices, before)


def test_create_row_sparse_forms_match_reference():
    data = np.arange(6, dtype=np.float32).reshape(2, 3)
    forms = [
        lambda m, **k: m.nd.sparse.row_sparse_array((data, [1, 3]), **k),
        lambda m, **k: m.nd.sparse.row_sparse_array((data, [1, 3]),
                                                    shape=(6, 3), **k),
        lambda m, **k: m.nd.sparse.row_sparse_array((4, 3), **k),
        lambda m, **k: m.nd.sparse.row_sparse_array(_rand((5, 3), 0.3, 5),
                                                    **k),
    ]
    for form in forms:
        _components_equal(form(mt, ctx=CPU), form(mx))
    for stype in ("csr", "row_sparse"):
        z = mt.nd.sparse.zeros(stype, (4, 3), ctx=CPU)
        assert z.stype == stype and z.shape == (4, 3)
        assert np.array_equal(z.asnumpy(), np.zeros((4, 3)))
        assert mt.nd.sparse.empty(stype, (4, 3), ctx=CPU).stype == stype
    with pytest.raises(MXNetError, match="2-D"):
        mt.nd.sparse.zeros("csr", (2, 3, 4), ctx=CPU)
    with pytest.raises(ValueError, match="shape"):
        mt.nd.sparse.csr_matrix(np.ones((2, 2), np.float32), shape=(3, 3),
                                ctx=CPU)
    with pytest.raises(ValueError, match="infer"):
        mt.nd.sparse.row_sparse_array((np.zeros((0, 2)), []), ctx=CPU)


# ---------------------------------------------------------------------------
# casts, retain, formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", STYPES)
@pytest.mark.parametrize("dst", STYPES)
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_cast_storage_round_trips_match_reference(src, dst, density):
    d = _rand((8, 6), density, seed=int(density * 10))
    t = mt.nd.sparse.cast_storage(_t(d, src), dst)
    j = mx.nd.sparse.cast_storage(_j(d, src), dst)
    assert t.stype == dst == j.stype
    np.testing.assert_array_equal(t.asnumpy(), d)
    if dst != "default":
        _components_equal(t, j)
        t.check_format()
    assert t.tostype("default").stype == "default"


def test_tostype_keeps_dtype_and_nd_array_keeps_storage():
    d = _rand((4, 5), 0.5, 6).astype(np.float64)
    t = mt.nd.array(d, ctx=CPU, dtype="float64").tostype("csr")
    assert t.dtype == np.float64
    assert mt.nd.array(t).stype == "csr"
    assert mt.nd.array(t.tostype("row_sparse")).stype == "row_sparse"


@pytest.mark.parametrize("ids", [[0, 2], [4, 1, 3], [5], []])
def test_retain_matches_reference(ids):
    d = _rand((6, 3), 0.6, 7)
    t = mt.nd.sparse.retain(_t(d, "row_sparse"), ids)
    j = mx.nd.sparse.retain(_j(d, "row_sparse"), ids)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    np.testing.assert_array_equal(t.indices.asnumpy(),
                                  np.asarray(j._sp_indices))
    dense_op = mt.nd._sparse_retain(_t(d), _t(np.asarray(ids, np.float32)))
    np.testing.assert_array_equal(
        dense_op.asnumpy(),
        mx.nd._sparse_retain(_j(d), _j(np.asarray(ids))).asnumpy())


@pytest.mark.parametrize("case", range(7))
def test_check_format_matches_reference(case):
    """Each malformed array fails in both packages; each valid one passes
    in both."""
    csr = [((np.array([1., 2.]), np.array([0, 1]), np.array([0, 1, 2])),
            (2, 3)),                                   # valid
           ((np.array([1., 2.]), np.array([1, 0]), np.array([0, 2, 2])),
            (2, 3)),                                   # unsorted row
           ((np.array([1., 2.]), np.array([0, 5]), np.array([0, 1, 2])),
            (2, 3)),                                   # column out of range
           ((np.array([1., 2.]), np.array([0, 1]), np.array([0, 2, 1])),
            (2, 3)),                                   # indptr decreases
           ((np.array([1., 2.]), np.array([0, 1]), np.array([1, 1, 2])),
            (2, 3))]                                   # indptr[0] != 0
    rsp = [((np.ones((2, 2)), np.array([0, 3])), (4, 2)),   # valid
           ((np.ones((2, 2)), np.array([3, 0])), (4, 2))]   # not ascending
    if case < len(csr):
        (data, ind, ptr), shape = csr[case]
        j = mx.nd.sparse.csr_matrix((data, ind, ptr), shape=shape)
        t = mt.nd.sparse.csr_matrix((data, ind, ptr), shape=shape, ctx=CPU)
    else:
        (data, ind), shape = rsp[case - len(csr)]
        j = mx.nd.sparse.row_sparse_array((data, ind), shape=shape)
        t = mt.nd.sparse.row_sparse_array((data, ind), shape=shape, ctx=CPU)
    try:
        j.check_format()
        ok = True
    except mx.base.MXNetError:
        ok = False
    if ok:
        t.check_format()
    else:
        with pytest.raises(MXNetError, match="check_format"):
            t.check_format()


# ---------------------------------------------------------------------------
# dot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (False, True),
                                             (True, False), (True, True)])
@pytest.mark.parametrize("lhs_density", [0.05, 0.5, 1.0])
@pytest.mark.parametrize("lhs_stype", ["csr", "default"])
@pytest.mark.parametrize("rhs_stype", ["default", "csr"])
def test_dot_grid_matches_reference(trans_a, trans_b, lhs_density,
                                    lhs_stype, rhs_stype):
    m, k, n = 13, 17, 7
    lhs = _rand((k, m) if trans_a else (m, k), lhs_density, seed=1)
    rhs = _rand((n, k) if trans_b else (k, n), 0.6, seed=2)
    for fwd in (None, "default", "csr", "row_sparse"):
        t = mt.nd.sparse.dot(_t(lhs, lhs_stype), _t(rhs, rhs_stype),
                             transpose_a=trans_a, transpose_b=trans_b,
                             forward_stype=fwd)
        j = mx.nd.sparse.dot(_j(lhs, lhs_stype), _j(rhs, rhs_stype),
                             transpose_a=trans_a, transpose_b=trans_b,
                             forward_stype=fwd)
        want = j.tostype("default").asnumpy()
        np.testing.assert_allclose(t.tostype("default").asnumpy(), want,
                                   rtol=RTOL, atol=RTOL * np.abs(want).max())
        assert t.stype == j.stype


def test_dot_zero_output_rows_and_empty_csr():
    lhs = np.zeros((20, 30), np.float32)
    lhs[3, 4] = 1.0
    rhs = _rand((30, 8), 1.0, seed=3)
    rhs[4, :] = 0
    out = mt.nd.sparse.dot(_t(lhs, "csr"), _t(rhs))
    np.testing.assert_array_equal(out.asnumpy(), lhs @ rhs)
    empty = mt.nd.sparse.zeros("csr", (20, 30), ctx=CPU)
    for ta in (False, True):
        r = _rand((20 if ta else 30, 8), 1.0, seed=4)
        got = mt.nd.sparse.dot(empty, _t(r), transpose_a=ta)
        assert got.shape == ((30 if ta else 20), 8)
        assert not got.asnumpy().any()


@pytest.mark.parametrize("transpose_a", [False, True])
def test_dot_determinism(transpose_a):
    """The reference's determinism case (`test_sparse_dot_determinism`):
    each output row or column is summed as one run in order, so reruns
    are bit-equal."""
    lhs = _t(_rand((60, 70), 0.1, seed=5), "csr")
    rhs = _t(_rand((70 if not transpose_a else 60, 40), 1.0, seed=6))
    r1 = mt.nd.sparse.dot(lhs, rhs, transpose_a=transpose_a,
                          forward_stype="row_sparse")
    r2 = mt.nd.sparse.dot(lhs, rhs, transpose_a=transpose_a,
                          forward_stype="row_sparse")
    np.testing.assert_array_equal(r1.asnumpy(), r2.asnumpy())


def test_dot_gradient_to_dense_operand_matches_reference():
    lhs = _rand((5, 6), 0.4, seed=10)
    rhs = _rand((6, 3), 1.0, seed=11)
    grads = []
    for m, mk in ((mx, _j), (mt, _t)):
        w = mk(rhs)
        w.attach_grad()
        with m.autograd.record():
            y = m.nd.sparse.dot(mk(lhs, "csr"), w)
            loss = (y * y).sum()
        loss.backward()
        grads.append(w.grad.asnumpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=RTOL, atol=1e-6)


def test_dot_gradient_through_recorded_csr_matches_reference():
    lhs = _rand((4, 5), 0.5, seed=12)
    rhs = _rand((5, 2), 1.0, seed=13)
    grads = []
    for m, mk in ((mx, _j), (mt, _t)):
        x = mk(lhs)
        x.attach_grad()
        with m.autograd.record():
            c = x.tostype("csr")
            y = m.nd.sparse.dot(c, mk(rhs), forward_stype="row_sparse")
            loss = y.tostype("default").sum()
        loss.backward()
        grads.append(x.grad.asnumpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(grads[1], np.tile(rhs.sum(1), (4, 1)),
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# the NDArray side: slicing, assignment, scalar ops, pickling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", [slice(1, 4), slice(None, 2), slice(3, None),
                                 slice(5, 2), 2, -1])
def test_csr_slices_keep_storage_like_reference(key):
    d = _rand((6, 5), 0.5, 14)
    t, j = _t(d, "csr")[key], _j(d, "csr")[key]
    _components_equal(t, j)
    t.check_format()


@pytest.mark.parametrize("stype", ["csr", "row_sparse"])
@pytest.mark.parametrize("value", ["dense", "sparse", 0.0, 2.5])
def test_whole_array_assignment_matches_reference(stype, value):
    d = _rand((4, 3), 0.5, 15)
    src = _rand((4, 3), 0.5, 16)
    t, j = _t(d, stype), _j(d, stype)
    if value == "dense":
        t[:], j[:] = _t(src), _j(src)
    elif value == "sparse":
        t[:], j[:] = _t(src, stype), _j(src, stype)
    else:
        t[:], j[:] = value, value
    _components_equal(t, j)
    with pytest.raises(MXNetError, match="whole-array"):
        t[1:2] = 0.0


@pytest.mark.parametrize("stype", ["csr", "row_sparse"])
@pytest.mark.parametrize("op", ["mul", "div", "add", "sub", "pow", "neg"])
def test_scalar_ops_keep_storage_like_reference(stype, op):
    d = _rand((5, 4), 0.4, 17)
    f = {"mul": lambda x: x * 3.0, "div": lambda x: x / 2.0,
         "add": lambda x: x + 1.0, "sub": lambda x: 2.0 - x,
         "pow": lambda x: x ** 2.0, "neg": lambda x: -x}[op]
    t, j = f(_t(d, stype)), f(_j(d, stype))
    assert t.stype == j.stype
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=RTOL)
    x = _t(d, stype)
    x *= 2.0                     # rebinds, as the reference's sparse x *= 2
    np.testing.assert_allclose(x.asnumpy(), 2 * d)


@pytest.mark.parametrize("stype", ["csr", "row_sparse"])
def test_dense_ops_densify_sparse_inputs(stype):
    a, b = _rand((6, 8), 0.5, 18), _rand((6, 8), 0.5, 19) + 0.1
    for name in ("broadcast_add", "broadcast_mul", "maximum", "exp"):
        args = (_t(a, stype), _t(b)) if name != "exp" else (_t(a, stype),)
        jargs = (_j(a, stype), _j(b)) if name != "exp" else (_j(a, stype),)
        np.testing.assert_allclose(getattr(mt.nd, name)(*args).asnumpy(),
                                   getattr(mx.nd, name)(*jargs).asnumpy(),
                                   rtol=RTOL)
    with pytest.raises(MXNetError, match="reshape"):
        _t(a, stype).reshape((48,))


@pytest.mark.parametrize("stype", ["csr", "row_sparse"])
def test_pickle_and_copy_keep_storage(stype):
    d = _rand((5, 6), 0.3, 20)
    t = _t(d, stype)
    back = pickle.loads(pickle.dumps(t))
    assert type(back) is type(t)
    _components_equal(back, _j(d, stype))
    c = t.copy()
    c[:] = 0.0
    np.testing.assert_array_equal(t.asnumpy(), d)


# ---------------------------------------------------------------------------
# tensor_extra: the ported ops against the JAX package's
# ---------------------------------------------------------------------------

def _both(op, inputs, **attrs):
    j = getattr(mx.nd, op)(*[mx.nd.array(x) for x in inputs], **attrs)
    t = getattr(mt.nd, op)(*[mt.nd.array(x, ctx=CPU) for x in inputs],
                           **attrs)
    js = j if isinstance(j, list) else [j]
    ts = t if isinstance(t, list) else [t]
    assert len(js) == len(ts)
    for a, b in zip(ts, js):
        assert a.shape == b.shape, op
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=RTOL,
                                   atol=1e-6, err_msg=op)


@pytest.mark.parametrize("axis,keepdims", [(None, False), (None, True),
                                           (0, False), (1, False), (1, True),
                                           ((0, 1), False)])
@pytest.mark.parametrize("stype", STYPES)
def test_square_sum_matches_reference(axis, keepdims, stype):
    d = _rand((10, 4), 0.4, 21)
    kw = {} if axis is None else {"axis": axis}
    t = mt.nd._square_sum(_t(d, stype), keepdims=keepdims, **kw)
    j = mx.nd._square_sum(_j(d, stype), keepdims=keepdims, **kw)
    assert t.shape == j.shape
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=RTOL)
    assert mt.sym._internal._square_sum is mt.sym._square_sum


@pytest.mark.parametrize("case", [
    ("batch_take", [np.arange(12.).reshape(3, 4), np.array([1., 3., 0.])],
     {}),
    ("choose_element_0index",
     [np.arange(12.).reshape(3, 4), np.array([2., 0., 1.])], {}),
    ("fill_element_0index", [np.zeros((3, 4)), np.array([5., 6., 7.]),
                             np.array([2., 0., 1.])], {}),
    ("depth_to_space", [np.arange(2 * 8 * 2 * 3.).reshape(2, 8, 2, 3)],
     {"block_size": 2}),
    ("space_to_depth", [np.arange(2 * 2 * 4 * 6.).reshape(2, 2, 4, 6)],
     {"block_size": 2}),
    ("khatri_rao", [np.arange(6.).reshape(2, 3),
                    np.arange(12.).reshape(4, 3)], {}),
    ("ravel_multi_index", [np.array([[1., 2.], [0., 3.]])],
     {"shape": (3, 4)}),
    ("unravel_index", [np.array([5., 11., 0.])], {"shape": (3, 4)}),
    ("histogram", [np.array([0.1, 0.5, 0.5, 0.9, 1.0, 2.0])],
     {"bin_cnt": 4, "range": (0.0, 1.0)}),
    ("_split_v2", [np.arange(24.).reshape(4, 6)],
     {"indices": (0, 2, 5), "axis": 1}),
    ("_split_v2", [np.arange(24.).reshape(4, 6)],
     {"sections": 2, "axis": 0, "squeeze_axis": False}),
    ("_slice_assign", [np.zeros((4, 5)), np.ones((2, 3))],
     {"begin": (1, 0), "end": (3, 3)}),
    ("_slice_assign_scalar", [np.zeros((4, 5))],
     {"begin": (0, 1), "end": (4, 5), "step": (2, 2), "scalar": 3.0}),
    ("_identity_with_attr_like_rhs", [np.ones((2, 2)), np.zeros((2, 2))],
     {}),
    ("cast_storage", [np.arange(4.).reshape(2, 2)], {"stype": "csr"}),
    ("_CrossDeviceCopy", [np.arange(3.)], {}),
    ("add_n", [np.ones((2, 3)), np.arange(6.).reshape(2, 3)], {}),
    ("_logical_and", [np.array([0., 1., 2.]), np.array([1., 0., 3.])], {}),
    ("_hypot", [np.array([3., 5.]), np.array([4., 12.])], {}),
    ("_rmod_scalar", [np.array([3., 4., 5.])], {"scalar": 7.0}),
    ("_LogicalXorScalar", [np.array([0., 2.])], {"scalar": 1.0}),
    ("dot", [np.arange(6.).reshape(2, 3), np.arange(12.).reshape(3, 4)],
     {}),
    ("dot", [np.arange(6.).reshape(3, 2), np.arange(12.).reshape(4, 3)],
     {"transpose_a": True, "transpose_b": True}),
], ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_tensor_extra_op_matches_reference(case):
    op, inputs, attrs = case
    _both(op, [np.asarray(x, np.float32) for x in inputs], **attrs)


def test_tensor_extra_aliases_registered():
    from mxnet_tpu_torch.ops import registry
    for name in ("ElementWiseSum", "_sum", "_grad_add", "broadcast_plus",
                 "broadcast_minus", "_rnn_param_concat", "_ravel_multi_index",
                 "_unravel_index", "_histogram", "_Equal", "_Hypot",
                 "_RModScalar", "_scatter_minus_scalar",
                 "_scatter_plus_scalar", "_scatter_elemwise_div",
                 "BatchNorm_v1", "CuDNNBatchNorm", "Convolution_v1",
                 "Pooling_v1", "_sparse_adagrad_update"):
        assert registry.get_op(name) is not None, name


def test_sample_unique_zipfian_statistics():
    out, tries = mt.nd._sample_unique_zipfian(shape=(4, 500), range_max=50,
                                             ctx=CPU)
    s = out.asnumpy()
    assert out.dtype == np.int32 and s.min() >= 0 and s.max() < 50
    # zipfian: the smallest classes are the most frequent
    assert (s == 0).mean() > (s == 25).mean()
    np.testing.assert_array_equal(tries.asnumpy(), np.full(4, 500))


@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
def test_make_loss_gradient_matches_reference(normalization):
    """``MakeLoss`` (the alias the file registers): identity forward, the
    backward's seed as the JAX package computes it."""
    x = _rand((4, 3), 0.7, 22)
    grads = []
    for m, mk in ((mx, _j), (mt, _t)):
        v = mk(x)
        v.attach_grad()
        with m.autograd.record():
            y = m.nd.MakeLoss(v * 2.0, grad_scale=0.5,
                              normalization=normalization,
                              valid_thresh=0.1)
        np.testing.assert_allclose(y.asnumpy(), 2 * x, rtol=RTOL)
        y.backward()
        grads.append(v.grad.asnumpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=RTOL)
