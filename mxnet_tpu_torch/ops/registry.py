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
FMutateInputs).  An op with ``program_state`` keeps state for the life of
one plan (a `Custom` op's operator instance, a control-flow op's body
plans): the plan builder gives each of its steps a dict of its own under
the ``PROGRAM_STATE`` attr.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..base import MXNetError, _Null, str_to_attr, torch_dtype

__all__ = ["Attrs", "OpDef", "register", "alias", "get_op", "list_ops",
           "apply_op", "eval_shape_op", "canonical_attrs",
           "split_positional_attrs", "attach_prefixed", "DEVICE",
           "PROGRAM_STATE", "register_validator", "get_validator"]

#: the attr through which a zero-input op learns the device to build on
DEVICE = "__device"
#: the attr through which a ``program_state`` op reaches its plan step's
#: own dict
PROGRAM_STATE = "__program_state"


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
                 attr_names: Optional[Sequence[str]] = None,
                 program_state: bool = False):
        self.name = name
        self.fn = fn
        self.num_inputs = num_inputs          # None => variadic
        self._num_outputs = num_outputs
        self.needs_rng = needs_rng            # fn(attrs, generator, *arrays)
        self.uses_train_mode = uses_train_mode  # executor injects __train
        # a tuple of slots, or a function of the attrs (`_subgraph_op`
        # mutates the outer inputs its inner graph mutates)
        self.mutate_inputs = mutate_inputs if callable(mutate_inputs) \
            else tuple(mutate_inputs)
        self.input_names = list(input_names) if input_names else None
        # attrs that may follow the tensors positionally, in this order
        # (``clip(data, a_min, a_max)``)
        self.attr_names = list(attr_names) if attr_names else None
        self.program_state = program_state
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
        if callable(self.mutate_inputs):
            return tuple(self.mutate_inputs(attrs))
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


#: attr validators, op name -> fn(Attrs) raising MXNetError.  Imperative
#: dispatch runs them on the host-known attrs and defers the failure to
#: the output's sync point (MXNet's parameter checks run inside its
#: asynchronous engine and surface at WaitToRead)
_VALIDATORS: Dict[str, Callable] = {}


def register_validator(name: str):
    def deco(fn):
        _VALIDATORS[name] = fn
        return fn
    return deco


def get_validator(name: str):
    """The validator of op ``name`` or of the op it aliases, or None."""
    op = _REGISTRY.get(name)
    return _VALIDATORS.get(op.name if op is not None else name)


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
