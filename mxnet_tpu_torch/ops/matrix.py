"""Shape and product ops of the ported paths (the counterparts of
`mxnet_tpu/ops/matrix.py`): dot, batch_dot, transpose, swapaxes, reshape,
Flatten, Pad, where, zeros_like/ones_like, Embedding, the sequence
plumbing of the unrolled RNN cells (SliceChannel/split, slice_axis,
Concat, stack, squeeze and expand_dims), and the zero-input
constructors ``_zeros``, ``_ones``, ``_full``, ``_arange`` and ``_eye``
that the ``fold_const`` pass folds.

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


@register("swapaxes", num_inputs=1, input_names=["data"])
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


@register("expand_dims", num_inputs=1, input_names=["data"])
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
