"""Operator registry: one plain PyTorch function per op name.

The counterpart of `mxnet_tpu/ops/registry.py`, with the same op names and
attrs.  Each op registers ``fn(attrs, *tensors) -> tensor | tuple``; the
same function runs eagerly in the executor and, on ``meta`` tensors,
answers shape inference (the reference traces it with `jax.eval_shape`).

Flags, as in the reference: an op that ``needs_rng`` takes an explicit
`torch.Generator` after its attrs (``fn(attrs, generator, *tensors)``,
where the JAX op takes a key); one that ``uses_train_mode`` reads the
``__train`` attr the executor injects; ``mutate_inputs`` names the input
slots whose new values follow the visible outputs (MXNet's
FMutateInputs).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..base import MXNetError, _Null, str_to_attr, torch_dtype

__all__ = ["Attrs", "OpDef", "register", "alias", "get_op", "list_ops",
           "apply_op", "eval_shape_op", "canonical_attrs",
           "split_positional_attrs", "attach_prefixed", "DEVICE"]

#: the attr through which a zero-input op learns the device to build on
DEVICE = "__device"


class Attrs(dict):
    """Op attributes with string-tolerant typed accessors: Symbol JSON
    stores every attr as a string, live calls pass python values, and both
    parse the same way."""

    def get_attr(self, key, default=None):
        v = self.get(key, _Null)
        if v is _Null or v is None:
            return default
        if isinstance(v, str):
            return str_to_attr(v)
        return v

    def get_int(self, key, default=None):
        v = self.get_attr(key, default)
        return None if v is None else int(v)

    def get_float(self, key, default=None):
        v = self.get_attr(key, default)
        return None if v is None else float(v)

    def get_bool(self, key, default=None):
        v = self.get_attr(key, default)
        if isinstance(v, str):
            return v.strip().lower() not in ("0", "false", "")
        return default if v is None else bool(v)

    def get_tuple(self, key, default=None):
        v = self.get_attr(key, default)
        if v is None:
            return default
        if isinstance(v, (int, float)):
            return (v,)
        return tuple(v)

    def get_str(self, key, default=None):
        v = self.get(key, _Null)
        if v is _Null or v is None or v == "None":
            return default
        return str(v)

    def get_dtype(self, key, default=None):
        v = self.get_str(key, None)
        return default if v is None else torch_dtype(v)


class OpDef:
    """One registered operator."""

    def __init__(self, name: str, fn: Callable, *,
                 num_inputs: Optional[int] = None, num_outputs: int = 1,
                 needs_rng: bool = False, uses_train_mode: bool = False,
                 mutate_inputs: Sequence[int] = (),
                 input_names: Optional[Sequence[str]] = None,
                 attr_names: Optional[Sequence[str]] = None):
        self.name = name
        self.fn = fn
        self.num_inputs = num_inputs          # None => variadic
        self._num_outputs = num_outputs
        self.needs_rng = needs_rng            # fn(attrs, generator, *arrays)
        self.uses_train_mode = uses_train_mode  # executor injects __train
        self.mutate_inputs = tuple(mutate_inputs)
        self.input_names = list(input_names) if input_names else None
        # attrs that may follow the tensors positionally, in this order
        # (``clip(data, a_min, a_max)``)
        self.attr_names = list(attr_names) if attr_names else None
        self.doc = fn.__doc__ or ""
        self.aliases: List[str] = []

    def num_outputs(self, attrs: Attrs) -> int:
        if callable(self._num_outputs):
            return self._num_outputs(attrs)
        return self._num_outputs

    @property
    def takes_device(self) -> bool:
        """A zero-input op: it builds its output on the ``__device``
        attr's device."""
        return self.num_inputs == 0

    def mutate_slots(self, attrs: Attrs) -> Tuple[int, ...]:
        """The input slots this op writes back (FMutateInputs)."""
        return self.mutate_inputs

    def __repr__(self):
        return f"<OpDef {self.name}>"


_REGISTRY: Dict[str, OpDef] = {}


def register(name: str, **opts) -> Callable:
    """Decorator: register a function as op ``name``."""
    def deco(fn):
        if name in _REGISTRY:
            raise MXNetError(f"op {name!r} already registered")
        _REGISTRY[name] = OpDef(name, fn, **opts)
        return fn
    return deco


def alias(name: str, *names: str):
    """Register alternate public names for op ``name``."""
    op = _REGISTRY[name]
    for n in names:
        _REGISTRY[n] = op
        op.aliases.append(n)


def get_op(name: str) -> OpDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise MXNetError(f"operator {name!r} is not registered") from None


def list_ops() -> List[str]:
    return sorted(_REGISTRY)


def attach_prefixed(target_globals: Dict, prefixes: Sequence[str],
                    invoke_fn: Callable,
                    target_all: Optional[List[str]] = None) -> None:
    """Fill a namespace (`nd.random`, `sym.linalg`, ...) with one wrapper
    per registered op whose name starts with one of ``prefixes``, under
    the name less the prefix (the JAX package's `attach_prefixed`)."""
    for name in list_ops():
        for prefix in prefixes:
            if not name.startswith(prefix):
                continue
            short = name[len(prefix):]
            if short in target_globals:
                continue

            def f(*args, _n=name, **kwargs):
                return invoke_fn(_n, *args, **kwargs)
            f.__name__ = short
            f.__doc__ = get_op(name).doc
            target_globals[short] = f
            if target_all is not None:
                target_all.append(short)
            break


def split_positional_attrs(op: OpDef, inputs: Sequence, kwargs: Dict,
                           tensor_type: type):
    """``(tensor inputs, attrs)``: the positional arguments past
    ``op.num_inputs`` mapped onto ``op.attr_names``, as the reference's
    generated signatures take them (the JAX package's
    `registry.split_positional_attrs`)."""
    if (op.num_inputs is None or not op.attr_names
            or len(inputs) <= op.num_inputs):
        return list(inputs), {}
    extra = inputs[op.num_inputs:]
    if len(extra) > len(op.attr_names):
        raise TypeError(
            f"op {op.name}: takes at most {op.num_inputs} tensor inputs "
            f"and {len(op.attr_names)} positional params, got "
            f"{len(inputs)} positional arguments")
    attrs = {}
    for pname, v in zip(op.attr_names, extra):
        if isinstance(v, tensor_type) or pname in kwargs:
            raise TypeError(f"op {op.name}: too many tensor inputs or "
                            f"duplicate value for {pname!r}")
        attrs[pname] = v
    return list(inputs[:op.num_inputs]), attrs


def canonical_attrs(kwargs: Dict[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    """A hashable form of an attr dict, in key order (the ``cse`` key)."""
    items = []
    for k in sorted(kwargs):
        v = kwargs[k]
        if v is _Null:
            continue
        if isinstance(v, list):
            v = tuple(v)
        items.append((k, v))
    return tuple(items)


def _attrs(kwargs: Dict[str, Any]) -> Attrs:
    return Attrs({k: v for k, v in kwargs.items() if v is not _Null})


def apply_op(name: str, tensors: Sequence[torch.Tensor],
             kwargs: Dict[str, Any],
             generator: Optional[torch.Generator] = None):
    """Run op ``name`` on tensors; returns a tuple of output tensors.  An
    op that needs randomness draws it from ``generator``."""
    op = get_op(name)
    if op.needs_rng:
        out = op.fn(_attrs(kwargs), generator, *tensors)
    else:
        out = op.fn(_attrs(kwargs), *tensors)
    return out if isinstance(out, tuple) else (out,)


def eval_shape_op(name: str, in_shapes, in_dtypes, kwargs: Dict[str, Any]):
    """Output shapes and dtypes of op ``name`` for the given inputs, by
    running it on ``meta`` tensors (no storage, no arithmetic)."""
    args = [torch.empty(tuple(s), dtype=d, device="meta")
            for s, d in zip(in_shapes, in_dtypes)]
    if get_op(name).takes_device:
        kwargs = dict(kwargs, **{DEVICE: "meta"})
    outs = apply_op(name, args, kwargs)
    return [tuple(o.shape) for o in outs], [o.dtype for o in outs]
