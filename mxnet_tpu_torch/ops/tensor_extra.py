"""The tensor ops' long tail (the counterpart of
`mxnet_tpu/ops/tensor_extra.py`): `src/operator/tensor/matrix_op.cc`
(depth_to_space, space_to_depth, _split_v2, _slice_assign),
`indexing_op.cc` (batch_take, ravel/unravel), `histogram.cc`,
`square_sum-inl.h`, `khatri_rao`, the storage ops ``cast_storage`` and
``_sparse_retain`` on dense tensors, ``add_n``, and the aliases the
reference registers with ``.add_alias``.

Index outputs (histogram counts, zipfian samples) are int32, the JAX
package's index dtype (the reference's int64, narrowed there because x64
is off).  The sparse conversions themselves live on the arrays
(`ndarray/sparse.py`); on a dense tensor ``cast_storage`` is the
identity.  The linear-algebra aliases (``_linalg_*``) wait for the
``linalg_*`` ops.
"""
from __future__ import annotations

import torch

from .registry import DEVICE, alias, register


# ---------------------------------------------------------------------------
# indexing and shape ops
# ---------------------------------------------------------------------------

@register("batch_take", num_inputs=2, input_names=["a", "indices"])
def _batch_take(attrs, a, indices):
    """Reference `batch_take` (`indexing_op.cc:733`): out[i] =
    a[i, indices[i]]."""
    a2 = a.reshape(a.shape[0], -1)
    idx = indices.reshape(-1).long()
    return torch.gather(a2, 1, idx[:, None])[:, 0]


def _d2s_perm(x, block, inverse):
    n, c, h, w = x.shape
    b = block
    if not inverse:  # depth_to_space, DCR layout (matrix_op.cc:1007)
        x = x.reshape(n, b, b, c // (b * b), h, w)
        x = x.permute(0, 3, 4, 1, 5, 2)
        return x.reshape(n, c // (b * b), h * b, w * b)
    x = x.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("depth_to_space", num_inputs=1, input_names=["data"])
def _depth_to_space(attrs, x):
    """Reference `depth_to_space` (`matrix_op.cc:1007`), DCR order on
    NCHW."""
    return _d2s_perm(x, attrs.get_int("block_size"), inverse=False)


@register("space_to_depth", num_inputs=1, input_names=["data"])
def _space_to_depth(attrs, x):
    """Reference `space_to_depth` (`matrix_op.cc:1065`)."""
    return _d2s_perm(x, attrs.get_int("block_size"), inverse=True)


@register("khatri_rao", input_names=None)
def _khatri_rao(attrs, *mats):
    """Column-wise Kronecker product (reference `khatri_rao`, `la_op.cc`):
    out[:, j] = kron(A[:, j], B[:, j], ...)."""
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum("ik,jk->ijk", out, m).reshape(-1, out.shape[1])
    return out


@register("ravel_multi_index", num_inputs=1, input_names=["data"])
def _ravel_multi_index(attrs, data):
    """Reference `_ravel_multi_index` (`ravel.cc`): (ndim, N) coordinate
    rows to flat indices under attr ``shape``."""
    shape = attrs.get_tuple("shape")
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= int(s)
    strides = torch.tensor(list(reversed(strides)), dtype=data.dtype,
                           device=data.device)
    return torch.tensordot(strides, data, dims=([0], [0]))


@register("unravel_index", num_inputs=1, input_names=["data"])
def _unravel_index(attrs, data):
    """Reference `_unravel_index`: flat indices to (ndim, N)
    coordinates."""
    shape = attrs.get_tuple("shape")
    coords = []
    rem = data.long() if data.dtype == torch.int64 else data.int()
    for s in reversed(shape):
        s = int(s)
        coords.append(torch.remainder(rem, s))
        rem = torch.div(rem, s, rounding_mode="floor")
    return torch.stack(list(reversed(coords)), dim=0).to(data.dtype)


@register("histogram", num_inputs=None, input_names=["data", "bins"],
          num_outputs=2)
def _histogram(attrs, data, bins=None):
    """Reference `_histogram` (`histogram.cc`): a bin-edges input, or
    attrs ``bin_cnt`` and ``range``; the last bin closed on the right."""
    x = data.reshape(-1)
    if bins is not None:
        edges = bins.reshape(-1)
        cnt = edges.shape[0] - 1
    else:
        cnt = attrs.get_int("bin_cnt")
        lo, hi = attrs.get_tuple("range")
        edges = torch.linspace(float(lo), float(hi), cnt + 1,
                               dtype=torch.float32, device=x.device)
    idx = torch.searchsorted(edges.contiguous(), x.to(edges.dtype),
                             right=True) - 1
    idx = torch.where(x == edges[-1], torch.full_like(idx, cnt - 1), idx)
    valid = (idx >= 0) & (idx < cnt)
    counts = torch.zeros((cnt,), dtype=torch.int32, device=x.device)
    counts = counts.index_add(0, torch.where(valid, idx, 0),
                              valid.to(torch.int32))
    return counts, edges


@register("_square_sum", num_inputs=1, input_names=["data"])
def _square_sum(attrs, x):
    """Reference `_square_sum` (`square_sum-inl.h`): sum(x²) over
    ``axis``."""
    axis = attrs.get_attr("axis", None)
    if isinstance(axis, (list, tuple)):
        axis = tuple(int(a) for a in axis)
    elif axis is not None:
        axis = (int(axis),)
    keep = attrs.get_bool("keepdims", False)
    if axis is None:
        out = torch.square(x).sum()
        return out.reshape((1,) * x.dim()) if keep else out
    return torch.square(x).sum(dim=axis, keepdim=keep)


def _split_v2_indices(attrs):
    """The split points: MXNet's frontend prepends 0 to ``indices``
    (`ndarray.py split_v2`), so (0, i1, i2) splits at [i1, i2]."""
    idx = [int(i) for i in attrs.get_tuple("indices", ())]
    if idx and idx[0] == 0:
        idx = idx[1:]
    return idx


def _split_v2_outputs(attrs):
    sections = attrs.get_int("sections", 0) or 0
    if sections > 0:
        return sections
    return len(_split_v2_indices(attrs)) + 1


@register("_split_v2", num_inputs=1, input_names=["data"],
          num_outputs=_split_v2_outputs)
def _split_v2(attrs, x):
    """Reference `_split_v2` (`matrix_op.cc`): equal sections or explicit
    split points, with optional squeeze."""
    axis = attrs.get_int("axis", 1)
    axis = axis % x.dim()
    sections = attrs.get_int("sections", 0) or 0
    if sections > 0:
        parts = torch.chunk(x, sections, dim=axis)
    else:
        pts = [0] + _split_v2_indices(attrs) + [x.shape[axis]]
        parts = [x.narrow(axis, a, b - a) for a, b in zip(pts, pts[1:])]
    if attrs.get_bool("squeeze_axis", False):
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


def _assign_slices(attrs):
    begin = attrs.get_tuple("begin")
    end = attrs.get_tuple("end")
    step = attrs.get_tuple("step", ()) or (None,) * len(begin)
    slices = []
    for i, (b, e) in enumerate(zip(begin, end)):
        s = step[i] if i < len(step) else None
        s = None if s in (None, 0) else int(s)
        slices.append(slice(None if b is None else int(b),
                            None if e is None else int(e), s))
    return tuple(slices)


@register("_slice_assign", num_inputs=2, input_names=["lhs", "rhs"])
def _slice_assign(attrs, lhs, rhs):
    """Reference `_slice_assign`: lhs with lhs[begin:end] = rhs, as a pure
    op."""
    out = lhs.clone()
    out[_assign_slices(attrs)] = rhs
    return out


@register("_slice_assign_scalar", num_inputs=1, input_names=["data"])
def _slice_assign_scalar(attrs, lhs):
    """Reference `_slice_assign_scalar`: lhs with lhs[begin:end] =
    scalar."""
    out = lhs.clone()
    out[_assign_slices(attrs)] = attrs.get_float("scalar", 0.0)
    return out


@register("_zeros_without_dtype", num_inputs=0)
def _zeros_without_dtype(attrs):
    """Reference `_zeros_without_dtype` (`init_op.cc`): float32 zeros."""
    return torch.zeros(attrs.get_tuple("shape", ()), dtype=torch.float32,
                       device=attrs.get(DEVICE))


@register("_identity_with_attr_like_rhs", num_inputs=2,
          input_names=["lhs", "rhs"])
def _identity_with_attr_like_rhs(attrs, lhs, rhs):
    """Reference `_identity_with_attr_like_rhs`: lhs (the storage attrs
    borrowed from rhs matter only to the reference's graph passes)."""
    return lhs


@register("add_n", input_names=None)
def _add_n(attrs, *arrays):
    """The elementwise sum of any number of arrays (reference `add_n`,
    `src/operator/tensor/elemwise_sum.cc`), added left to right."""
    out = arrays[0]
    for a in arrays[1:]:
        out = out + a
    return out


@register("_CrossDeviceCopy", num_inputs=1, input_names=["data"])
def _cross_device_copy(attrs, x):
    """Reference `_CrossDeviceCopy`: a graph runs on one device here, so
    the identity."""
    return x


@register("cast_storage", num_inputs=1, input_names=["data"])
def _cast_storage_op(attrs, x):
    """Reference `cast_storage` on a dense tensor: the identity (the
    sparse forms are `NDArray.tostype` and `sparse.cast_storage`)."""
    return x


@register("_sparse_retain", num_inputs=2, input_names=["data", "indices"])
def _sparse_retain_op(attrs, data, indices):
    """Reference `_sparse_retain` on a dense tensor: the rows not in
    ``indices`` zeroed (the row-sparse form is `sparse.retain`)."""
    keep = torch.zeros((data.shape[0],), dtype=torch.bool,
                       device=data.device)
    keep[indices.long().reshape(-1)] = True
    return torch.where(keep.reshape((-1,) + (1,) * (data.dim() - 1)), data,
                       torch.zeros_like(data))


@register("_sample_unique_zipfian", num_inputs=0, needs_rng=True,
          num_outputs=2)
def _sample_unique_zipfian(attrs, gen):
    """Reference `_sample_unique_zipfian` (`unique_sample_op.cc:42`):
    zipfian candidates for sampled softmax, P(c) = (log(c + 2) -
    log(c + 1)) / log(range_max + 1), as (samples, num_tries); a fixed
    draw with the expected tries, as in the JAX package."""
    shape = tuple(int(s) for s in attrs.get_tuple("shape"))
    range_max = attrs.get_int("range_max")
    device = attrs.get(DEVICE)
    u = torch.rand(shape, generator=gen, device=device)
    samples = torch.floor(torch.expm1(
        u * torch.log1p(torch.tensor(float(range_max))))).to(torch.int32)
    samples = samples.clamp(0, range_max - 1)
    num_tries = torch.full((shape[0],) if len(shape) > 1 else (1,),
                           shape[-1], dtype=samples.dtype, device=device)
    return samples, num_tries


@register("choose_element_0index", num_inputs=2,
          input_names=["lhs", "rhs"])
def _choose_element_0index(attrs, lhs, rhs):
    """lhs[i, rhs[i]] per row (reference legacy op, `ndarray_function.cc`
    Choose1DElementwise)."""
    return _batch_take(attrs, lhs, rhs)


@register("fill_element_0index", num_inputs=3,
          input_names=["lhs", "mhs", "rhs"])
def _fill_element_0index(attrs, lhs, mhs, rhs):
    """lhs with lhs[i, rhs[i]] = mhs[i] (reference legacy op,
    Fill1DElementwise)."""
    out = lhs.clone()
    out[torch.arange(lhs.shape[0], device=lhs.device), rhs.long()] = \
        mhs.to(lhs.dtype)
    return out


# ---------------------------------------------------------------------------
# aliases for the reference's ``.add_alias`` names
# ---------------------------------------------------------------------------

alias("add_n", "ElementWiseSum", "_sum")
alias("elemwise_add", "_grad_add")
alias("broadcast_add", "broadcast_plus")
alias("broadcast_sub", "broadcast_minus")
alias("Concat", "_rnn_param_concat")
alias("ravel_multi_index", "_ravel_multi_index")
alias("unravel_index", "_unravel_index")
alias("histogram", "_histogram")

# legacy capitalised elemwise aliases (`elemwise_binary_op*.cc`)
_CAP_ALIASES = {
    "_equal": "_Equal", "_not_equal": "_Not_Equal",
    "_greater": "_Greater", "_greater_equal": "_Greater_Equal",
    "_lesser": "_Lesser", "_lesser_equal": "_Lesser_Equal",
    "_logical_and": "_Logical_And", "_logical_or": "_Logical_Or",
    "_logical_xor": "_Logical_Xor",
    "_maximum": "_Maximum", "_minimum": "_Minimum",
    "_mod": "_Mod", "_hypot": "_Hypot",
    "_equal_scalar": "_EqualScalar", "_not_equal_scalar": "_NotEqualScalar",
    "_greater_scalar": "_GreaterScalar",
    "_greater_equal_scalar": "_GreaterEqualScalar",
    "_lesser_scalar": "_LesserScalar",
    "_lesser_equal_scalar": "_LesserEqualScalar",
    "_logical_and_scalar": "_LogicalAndScalar",
    "_logical_or_scalar": "_LogicalOrScalar",
    "_logical_xor_scalar": "_LogicalXorScalar",
    "_maximum_scalar": "_MaximumScalar", "_minimum_scalar": "_MinimumScalar",
    "_mod_scalar": "_ModScalar", "_hypot_scalar": "_HypotScalar",
    "_power_scalar": "_PowerScalar", "_rpower_scalar": "_RPowerScalar",
    "_rdiv_scalar": "_RDivScalar", "_rminus_scalar": "_RMinusScalar",
    "_rmod_scalar": "_RModScalar",
}
for _base, _al in _CAP_ALIASES.items():
    alias(_base, _al)

# the sparse-aware scalar variants (`elemwise_binary_scalar_op_basic.cc`):
# the dense math is the same, and the sparse arrays keep their storage at
# the NDArray layer (`BaseSparseNDArray._binop`)
alias("_minus_scalar", "_scatter_minus_scalar")
alias("_plus_scalar", "_scatter_plus_scalar")
alias("elemwise_div", "_scatter_elemwise_div")

# legacy v1 layer ops: parameter subsets of the modern ops
# (`batch_norm_v1.cc`, `convolution_v1.cc`, `pooling_v1.cc`)
alias("BatchNorm", "BatchNorm_v1", "CuDNNBatchNorm")
alias("Convolution", "Convolution_v1")
alias("Pooling", "Pooling_v1")
alias("make_loss", "MakeLoss")
