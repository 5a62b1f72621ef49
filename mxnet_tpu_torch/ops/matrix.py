"""Shape, indexing, ordering and product ops (the counterparts of
`mxnet_tpu/ops/matrix.py`): dot, batch_dot, transpose, swapaxes,
moveaxis, reshape and reshape_like, Flatten, Pad, where,
zeros_like/ones_like, the sequence plumbing of the unrolled RNN cells
(SliceChannel/split, slice_axis, Concat, stack, squeeze and
expand_dims), slice/crop and slice_like, tile, repeat, flip/reverse,
diag, shape_array and size_array; the indexing ops take, one_hot,
Embedding, gather_nd, scatter_nd and ``_scatter_set_nd``; the ordering
ops sort, argsort and topk; and the zero-input constructors ``_zeros``,
``_ones``, ``_full``, ``_arange``, ``_linspace`` and ``_eye`` that the
``fold_const`` pass folds.

Ordering follows ``jnp.argsort``/``lax.top_k``: ascending sorts are
stable (tied entries keep their order), a descending sort or argsort is
the ascending one reversed, and ``topk`` takes the lower index first among
tied entries.  Index outputs are float32 unless ``dtype`` says otherwise;
``shape_array``/``size_array`` give int64 (the reference's dtype; the JAX
package narrows them to int32 without x64).

A constructor has no input to take a device from: the executor hands it
the device its graph runs on as the ``__device`` attr (`registry.DEVICE`),
and shape inference hands it ``meta``; without one it builds on the
CPU."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import DEVICE, alias, register


@register("dot", num_inputs=2, input_names=["lhs", "rhs"])
def _dot(attrs, lhs, rhs):
    """Reference `dot` (`src/operator/tensor/dot-inl.h`): the last axis of
    lhs against the first of rhs (matrix semantics for N-D), with
    ``transpose_a``/``transpose_b`` reversing an operand's axes."""
    if attrs.get_bool("transpose_a", False):
        lhs = lhs.permute(*reversed(range(lhs.dim())))
    if attrs.get_bool("transpose_b", False):
        rhs = rhs.permute(*reversed(range(rhs.dim())))
    if lhs.dim() == 1 and rhs.dim() == 1:
        return torch.dot(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=([lhs.dim() - 1], [0]))


@register("batch_dot", num_inputs=2, input_names=["lhs", "rhs"])
def _batch_dot(attrs, lhs, rhs):
    """Batched matmul over the leading axes."""
    if attrs.get_bool("transpose_a", False):
        lhs = lhs.transpose(-1, -2)
    if attrs.get_bool("transpose_b", False):
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


@register("transpose", num_inputs=1, input_names=["data"])
def _transpose(attrs, x):
    axes = attrs.get_tuple("axes", None)
    if not axes:
        axes = tuple(reversed(range(x.dim())))
    return x.permute(*axes)


@register("swapaxes", num_inputs=1, input_names=["data"],
          attr_names=["dim1", "dim2"])
def _swapaxes(attrs, x):
    return x.transpose(attrs.get_int("dim1", 0), attrs.get_int("dim2", 0))


alias("swapaxes", "SwapAxis")


# ---------------------------------------------------------------------------
# zero-input constructors (reference src/operator/tensor/init_op.h)
# ---------------------------------------------------------------------------

def _placement(attrs):
    return dict(device=attrs.get(DEVICE),
                dtype=attrs.get_dtype("dtype", torch.float32))


@register("_zeros", num_inputs=0)
def _zeros(attrs):
    return torch.zeros(attrs.get_tuple("shape", ()), **_placement(attrs))


@register("_ones", num_inputs=0)
def _ones(attrs):
    return torch.ones(attrs.get_tuple("shape", ()), **_placement(attrs))


@register("_full", num_inputs=0)
def _full(attrs):
    return torch.full(attrs.get_tuple("shape", ()),
                      attrs.get_float("value"), **_placement(attrs))


@register("_arange", num_inputs=0)
def _arange(attrs):
    """start, start + step, ... below stop (``stop`` None: 0 up to
    ``start``), each value ``repeat`` times."""
    start = attrs.get_float("start", 0.0)
    stop = attrs.get_attr("stop", None)
    step = attrs.get_float("step", 1.0)
    if stop in (None, "None"):
        start, stop = 0.0, start
    arr = torch.arange(start, float(stop), step, **_placement(attrs))
    rep = attrs.get_int("repeat", 1)
    return arr.repeat_interleave(rep) if rep > 1 else arr


@register("_eye", num_inputs=0)
def _eye(attrs):
    """Ones on diagonal ``k`` of an N x M matrix (M 0 means N)."""
    n = attrs.get_int("N")
    m = attrs.get_int("M", 0) or n
    where = _placement(attrs)
    rows = torch.arange(n, device=where["device"])[:, None]
    cols = torch.arange(m, device=where["device"])[None, :]
    return (cols - rows == attrs.get_int("k", 0)).to(where["dtype"])


def infer_reshape(old_shape, new_shape):
    """MXNet reshape codes (reference `matrix_op-inl.h` ReshapeParam): 0
    copies a dim, -1 infers one dim, -2 copies all remaining dims, -3
    merges the next two input dims, -4 splits one input dim into the two
    spec values that follow."""
    out = []
    src = 0
    spec = list(new_shape)
    i = 0
    while i < len(spec):
        s = spec[i]
        if s == 0:
            out.append(old_shape[src])
            src += 1
        elif s == -1:
            out.append(-1)
            src += 1
        elif s == -2:
            out.extend(old_shape[src:])
            src = len(old_shape)
        elif s == -3:
            out.append(old_shape[src] * old_shape[src + 1])
            src += 2
        elif s == -4:
            d1, d2 = spec[i + 1], spec[i + 2]
            if d1 == -1:
                d1 = old_shape[src] // d2
            elif d2 == -1:
                d2 = old_shape[src] // d1
            out.extend([int(d1), int(d2)])
            src += 1
            i += 2
        else:
            out.append(int(s))
            src += 1
        i += 1
    if -1 in out:
        known = math.prod(s for s in out if s != -1)
        out[out.index(-1)] = math.prod(old_shape) // max(known, 1)
    return tuple(out)


@register("reshape", num_inputs=1, input_names=["data"])
def _reshape(attrs, x):
    shape = attrs.get_tuple("shape")
    if attrs.get_bool("reverse", False):
        inferred = infer_reshape(tuple(reversed(x.shape)),
                                 tuple(reversed(shape)))
        return x.reshape(tuple(reversed(inferred)))
    return x.reshape(infer_reshape(tuple(x.shape), shape))


alias("reshape", "Reshape")


@register("Embedding", num_inputs=2, input_names=["data", "weight"])
def _embedding(attrs, data, weight):
    """weight[(int)data]: float ids truncate to integers, out-of-range ids
    clip to the table."""
    idx = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    out = weight[idx]
    dtype = attrs.get_dtype("dtype", None)
    return out if dtype is None else out.to(dtype)


@register("expand_dims", num_inputs=1, input_names=["data"],
          attr_names=["axis"])
def _expand_dims(attrs, x):
    return x.unsqueeze(attrs.get_int("axis", 0))


@register("slice_axis", num_inputs=1, input_names=["data"])
def _slice_axis(attrs, x):
    """x[begin:end] along ``axis`` (``end`` None runs to the end)."""
    ax = attrs.get_int("axis")
    b = attrs.get_int("begin", 0)
    e = attrs.get_attr("end", None)
    idx = [slice(None)] * x.dim()
    idx[ax % x.dim()] = slice(b, None if e in (None, "None") else int(e))
    return x[tuple(idx)]


@register("Concat", num_inputs=None, input_names=None)
def _concat(attrs, *xs):
    """Reference `Concat` (`src/operator/nn/concat.cc`), along ``dim``."""
    return torch.cat(xs, dim=attrs.get_int("dim", 1))


alias("Concat", "concat")


@register("stack", num_inputs=None)
def _stack(attrs, *xs):
    return torch.stack(xs, dim=attrs.get_int("axis", 0))


@register("squeeze", num_inputs=1, input_names=["data"],
          attr_names=["axis"])
def _squeeze(attrs, x):
    ax = attrs.get_attr("axis", None)
    if ax is None:
        return x.squeeze()
    axes = ax if isinstance(ax, tuple) else (ax,)
    for a in axes:
        if x.shape[a] != 1:
            raise ValueError(f"squeeze: axis {a} has size {x.shape[a]}")
    return x.squeeze(tuple(a % x.dim() for a in axes))


@register("SliceChannel", num_inputs=1, input_names=["data"],
          num_outputs=lambda a: a.get_int("num_outputs"))
def _slice_channel(attrs, x):
    """Reference `SliceChannel`/`split` (`src/operator/slice_channel.cc`):
    ``num_outputs`` equal parts along ``axis``, each a view, squeezed with
    ``squeeze_axis``."""
    n = attrs.get_int("num_outputs")
    ax = attrs.get_int("axis", 1) % x.dim()
    if x.shape[ax] % n:
        raise ValueError(f"SliceChannel: axis {ax} of length {x.shape[ax]} "
                         f"does not split into {n} equal parts")
    parts = torch.split(x, x.shape[ax] // n, dim=ax)
    if attrs.get_bool("squeeze_axis", False):
        parts = tuple(p.squeeze(ax) for p in parts)
    return tuple(parts)


alias("SliceChannel", "split")


@register("Flatten", num_inputs=1, input_names=["data"])
def _flatten(attrs, x):
    """Reference `Flatten`: every axis but the first collapsed into one."""
    return x.reshape(x.shape[0], -1)


alias("Flatten", "flatten")


_PAD_MODES = {"edge": "replicate", "reflect": "reflect"}


@register("Pad", num_inputs=1, input_names=["data"])
def _pad(attrs, x):
    """Reference `Pad` (`src/operator/pad.cc`): ``pad_width`` is a flat
    (before, after) pair per axis; ``constant`` fills with
    ``constant_value``, ``edge`` repeats the border and ``reflect``
    mirrors it, on the spatial axes only (the first two pairs are 0)."""
    pw = [int(p) for p in attrs.get_tuple("pad_width")]
    mode = attrs.get_str("mode", "constant")
    if mode == "constant":
        flat = []
        for i in reversed(range(x.dim())):
            flat += [pw[2 * i], pw[2 * i + 1]]
        return F.pad(x, flat, value=attrs.get_float("constant_value", 0.0))
    if any(pw[:4]):
        raise ValueError(f"Pad: mode {mode!r} pads the spatial axes only; "
                         f"got pad_width {tuple(pw)}")
    flat = []
    for i in reversed(range(2, x.dim())):
        flat += [pw[2 * i], pw[2 * i + 1]]
    return F.pad(x, flat, mode=_PAD_MODES[mode])


alias("Pad", "pad")


@register("where", num_inputs=3, input_names=["condition", "x", "y"])
def _where(attrs, cond, x, y):
    """Reference `where` (`control_flow_op.h`): ``condition`` has x's
    shape, or is 1-D of length x.shape[0] and selects whole rows."""
    if cond.dim() == 1 and x.dim() > 1 and cond.shape[0] == x.shape[0]:
        cond = cond.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(cond != 0, x, y)


@register("zeros_like", num_inputs=1, input_names=["data"])
def _zeros_like(attrs, x):
    return torch.zeros_like(x)


@register("ones_like", num_inputs=1, input_names=["data"])
def _ones_like(attrs, x):
    return torch.ones_like(x)


@register("_linspace", num_inputs=0,
          attr_names=["start", "stop", "num", "endpoint"])
def _linspace(attrs):
    """``num`` evenly spaced values from start to stop (stop excluded
    without ``endpoint``)."""
    start, stop = attrs.get_float("start"), attrs.get_float("stop")
    num = attrs.get_int("num")
    where = _placement(attrs)
    if attrs.get_bool("endpoint", True):
        return torch.linspace(start, stop, num, **where)
    step = (stop - start) / num
    return (start + step * torch.arange(num, device=where["device"],
                                        dtype=torch.float64)
            ).to(where["dtype"])


alias("_linspace", "linspace")


@register("reshape_like", num_inputs=2, input_names=["lhs", "rhs"])
def _reshape_like(attrs, lhs, rhs):
    return lhs.reshape(rhs.shape)


@register("moveaxis", num_inputs=1, input_names=["data"],
          attr_names=["source", "destination"])
def _moveaxis(attrs, x):
    return torch.movedim(x, attrs.get_attr("source"),
                         attrs.get_attr("destination"))


def _axis_slice(x, axis, start, stop, step):
    """x[start:stop:step] along ``axis``; a negative step (which torch's
    basic slicing refuses) selects the same indices as Python's."""
    if step is None or step > 0:
        idx = [slice(None)] * x.dim()
        idx[axis] = slice(start, stop, step)
        return x[tuple(idx)]
    picks = list(range(*slice(start, stop, step).indices(x.shape[axis])))
    return x.index_select(axis, torch.tensor(picks, dtype=torch.int64,
                                             device=x.device))


def _opt(v):
    return None if v in (None, "None") else int(v)


@register("slice", num_inputs=1, input_names=["data"])
def _slice(attrs, x):
    """Python slicing per leading axis: ``begin``/``end``/``step`` tuples,
    None for the full range (reference `SliceParam`)."""
    begin = attrs.get_tuple("begin")
    end = attrs.get_tuple("end")
    step = attrs.get_tuple("step", None) or (None,) * len(begin)
    for ax, (b, e) in enumerate(zip(begin, end)):
        s = _opt(step[ax]) if ax < len(step) else None
        x = _axis_slice(x, ax, _opt(b), _opt(e), s)
    return x


alias("slice", "crop")


@register("slice_like", num_inputs=2, input_names=["data", "shape_like"])
def _slice_like(attrs, x, like):
    """``x`` cut to ``shape_like``'s extent on ``axes`` (every shared axis
    when none is given)."""
    axes = attrs.get_tuple("axes", None)
    if axes is None:
        axes = range(min(x.dim(), like.dim()))
    idx = [slice(None)] * x.dim()
    for a in axes:
        idx[a] = slice(0, like.shape[a])
    return x[tuple(idx)]


@register("tile", num_inputs=1, input_names=["data"])
def _tile(attrs, x):
    return x.tile(tuple(int(r) for r in attrs.get_tuple("reps")))


@register("repeat", num_inputs=1, input_names=["data"])
def _repeat(attrs, x):
    """Each element ``repeats`` times along ``axis`` (of the flattened
    array when none is given)."""
    ax = attrs.get_attr("axis", None)
    return torch.repeat_interleave(x, attrs.get_int("repeats"),
                                   dim=None if ax is None else int(ax))


@register("reverse", num_inputs=1, input_names=["data"])
def _reverse(attrs, x):
    ax = attrs.get_attr("axis")
    return torch.flip(x, (ax,) if isinstance(ax, int) else tuple(ax))


alias("reverse", "flip")


@register("diag", num_inputs=1, input_names=["data"])
def _diag(attrs, x):
    """The k-th diagonal of a matrix (of ``axis1``/``axis2`` for N-D), or
    a matrix with a vector on its k-th diagonal."""
    k = attrs.get_int("k", 0)
    if x.dim() == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=attrs.get_int("axis1", 0),
                          dim2=attrs.get_int("axis2", 1))


@register("shape_array", num_inputs=1, input_names=["data"])
def _shape_array(attrs, x):
    return torch.tensor(tuple(x.shape), dtype=torch.int64, device=x.device)


@register("size_array", num_inputs=1, input_names=["data"])
def _size_array(attrs, x):
    return torch.tensor([x.numel()], dtype=torch.int64, device=x.device)


# ---------------------------------------------------------------------------
# indexing (reference src/operator/tensor/indexing_op.h)
# ---------------------------------------------------------------------------

@register("take", num_inputs=2, input_names=["a", "indices"])
def _take(attrs, a, indices):
    """Slices of ``a`` along ``axis`` at ``indices``; an index outside the
    axis is clipped into it (``mode='clip'``, also for ``'raise'``) or
    wrapped (``'wrap'``)."""
    ax = attrs.get_int("axis", 0) % a.dim()
    n = a.shape[ax]
    idx = indices.to(torch.int64)
    if attrs.get_str("mode", "clip") == "wrap":
        idx = torch.remainder(idx, n)
    else:
        idx = idx.clamp(0, n - 1)
    out = a.index_select(ax, idx.reshape(-1))
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


alias("Embedding", "_contrib_SparseEmbedding")


@register("one_hot", num_inputs=1, input_names=["indices"])
def _one_hot(attrs, indices):
    """``on_value`` at each index of a ``depth``-long last axis,
    ``off_value`` elsewhere (an index outside [0, depth) gives a row of
    ``off_value``), in ``dtype`` (float32 by default)."""
    depth = attrs.get_int("depth")
    on = attrs.get_float("on_value", 1.0)
    off = attrs.get_float("off_value", 0.0)
    dt = attrs.get_dtype("dtype", torch.float32)
    hot = (indices.to(torch.int64)[..., None]
           == torch.arange(depth, device=indices.device)).to(torch.float32)
    return (hot * (on - off) + off).to(dt)


def _nd_index(indices):
    idx = indices.to(torch.int64)
    return tuple(idx[i] for i in range(idx.shape[0]))


@register("gather_nd", num_inputs=2, input_names=["data", "indices"])
def _gather_nd(attrs, data, indices):
    """``indices`` (M, ...) index the first M axes of ``data``; a repeated
    index adds its gradients."""
    return data[_nd_index(indices)]


@register("scatter_nd", num_inputs=2, input_names=["data", "indices"])
def _scatter_nd(attrs, data, indices):
    """Zeros of ``shape`` with ``data`` written at ``indices`` (gather_nd's
    inverse; where an index repeats, one of its values is kept)."""
    out = torch.zeros(tuple(attrs.get_tuple("shape")), dtype=data.dtype,
                      device=data.device)
    return out.index_put(_nd_index(indices), data)


@register("_scatter_set_nd", num_inputs=3,
          input_names=["lhs", "rhs", "indices"])
def _scatter_set_nd(attrs, lhs, rhs, indices):
    return lhs.index_put(_nd_index(indices), rhs)


# ---------------------------------------------------------------------------
# ordering (reference src/operator/tensor/ordering_op-inl.h)
# ---------------------------------------------------------------------------

def _ordering_axis(attrs, x):
    """``(x, axis)``: an explicit ``axis=None`` sorts the flattened array,
    a missing one means -1."""
    raw = attrs.get("axis", -1)
    if raw in (None, "None"):
        return x.reshape(-1), 0
    return x, attrs.get_int("axis", -1) % max(x.dim(), 1)


def _index_dtype(attrs):
    return attrs.get_dtype("dtype", torch.float32)


@register("sort", num_inputs=1, input_names=["data"])
def _sort(attrs, x):
    x, ax = _ordering_axis(attrs, x)
    out = torch.sort(x, dim=ax, stable=True).values
    return out if attrs.get_bool("is_ascend", True) else out.flip(ax)


@register("argsort", num_inputs=1, input_names=["data"])
def _argsort(attrs, x):
    x, ax = _ordering_axis(attrs, x)
    idx = torch.sort(x, dim=ax, stable=True).indices
    if not attrs.get_bool("is_ascend", True):
        idx = idx.flip(ax)
    return idx.to(_index_dtype(attrs))


@register("topk", num_inputs=1, input_names=["data"],
          num_outputs=lambda a: 2 if a.get_str("ret_typ", "indices")
          == "both" else 1)
def _topk(attrs, x):
    """The ``k`` largest (smallest with ``is_ascend``) entries along
    ``axis``: their values, indices, a 0/1 mask of them, or values and
    indices (``ret_typ`` value, indices, mask, both)."""
    x, ax = _ordering_axis(attrs, x)
    k = attrs.get_int("k", 1)
    ret = attrs.get_str("ret_typ", "indices")
    dt = _index_dtype(attrs)
    desc = not attrs.get_bool("is_ascend", False)
    order = torch.sort(x, dim=ax, descending=desc, stable=True)
    vals = order.values.narrow(ax, 0, k)
    idxs = order.indices.narrow(ax, 0, k)
    if ret == "value":
        return vals
    if ret == "indices":
        return idxs.to(dt)
    if ret == "mask":
        return torch.zeros(x.shape, dtype=dt, device=x.device).scatter(
            ax, idxs, 1)
    return vals, idxs.to(dt)
