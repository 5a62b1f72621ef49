"""Symbol: declarative graph construction (the counterpart of
`mxnet_tpu/symbol/symbol.py`, with the subset the ported paths need).

A Symbol is a list of output entries ``(node, out_index)`` over an
immutable DAG of nodes.  Arithmetic composes as in the JAX package: ``+``,
``-``, ``*`` and ``/`` between Symbols make broadcast nodes, and with a
number the scalar ops (``2 - s`` is ``_rminus_scalar``).  The JSON format
(`tojson` / `load_json`) is the JAX package's, character for character, so
one symbol file means the same graph in both packages.  Shape inference runs each op on ``meta`` tensors
in topological order, with the backward rules of `param_infer.py` filling
parameter shapes from data shapes.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..attribute import current as _attr_scope
from ..attribute import strip_annotations
from ..base import (MXNetError, NotImplementedForSymbol, dtype_name,
                    dtype_np, str_to_attr, torch_dtype)
from ..context import default_context
from ..ops import registry as _reg
from ..ops.registry import Attrs
from .param_infer import infer_param_shapes

__all__ = ["Symbol", "var", "Group", "load", "load_json",
           "name_prefix_scope"]


class _NameManager(threading.local):
    def __init__(self):
        super().__init__()
        self.counters: Dict[str, int] = {}
        self.prefix: List[str] = []

    def get(self, hint: str) -> str:
        i = self.counters.get(hint, 0)
        self.counters[hint] = i + 1
        return "".join(self.prefix) + f"{hint.lower()}{i}"


_NAMES = _NameManager()


class name_prefix_scope:
    """``with name_prefix_scope("stage1_"): ...``: every name made inside
    starts with the prefix (reference `name.py` `Prefix`)."""

    def __init__(self, prefix: str):
        self.prefix = prefix

    def __enter__(self):
        _NAMES.prefix.append(self.prefix)
        return self

    def __exit__(self, *exc):
        _NAMES.prefix.pop()


class _Node:
    """One graph node (op instance or variable)."""
    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs")

    def __init__(self, op: Optional[str], name: str, attrs: Dict[str, Any],
                 inputs: List[Tuple["_Node", int]]):
        self.op = op                      # None => variable
        self.name = name
        self.attrs = attrs
        self.inputs = inputs
        self.num_outputs = 1 if op is None else _reg.get_op(op).num_outputs(
            Attrs(strip_annotations(attrs)))

    @property
    def is_var(self) -> bool:
        return self.op is None


def _topo(heads: Sequence[Tuple[_Node, int]]) -> List[_Node]:
    """Post-order DFS over the DAG (inputs first), iterative so that deep
    graphs do not hit the recursion limit."""
    seen = set()
    order: List[_Node] = []
    for (head, _) in heads:
        if id(head) in seen:
            continue
        seen.add(id(head))
        stack = [(head, iter(head.inputs))]
        while stack:
            node, it = stack[-1]
            for (inp, _) in it:
                if id(inp) not in seen:
                    seen.add(id(inp))
                    stack.append((inp, iter(inp.inputs)))
                    break
            else:
                stack.pop()
                order.append(node)
    return order


def _entry_key(entry: Tuple[_Node, int]) -> str:
    node, idx = entry
    return f"{node.name}#{idx}"


def _value_key(entry: Tuple[_Node, int]) -> str:
    """Key of an entry's value: a variable under its plain name."""
    node, idx = entry
    return node.name if node.is_var else f"{node.name}#{idx}"


def _type_of(dtype):
    """A dtype as `Symbol.infer_type` gives it: numpy's, or
    ``torch.bfloat16``."""
    return dtype_np(torch_dtype(dtype)) if isinstance(dtype, torch.dtype) \
        or str(dtype) in ("bfloat16", "bf16") else np.dtype(dtype)


def _result_type(dts):
    """The promotion of ``dts``: numpy's, with bfloat16 as the JAX package
    promotes it (a wider float wins, float16 and bfloat16 give float32,
    integers give bfloat16)."""
    if not any(d is torch.bfloat16 for d in dts):
        return np.result_type(*dts)
    floats = [d for d in dts
              if d is not torch.bfloat16 and np.issubdtype(d, np.floating)]
    if not floats:
        return torch.bfloat16
    wide = np.result_type(*floats)
    return wide if wide.itemsize >= 4 else np.dtype(np.float32)


class Symbol:
    """A list of output entries over the node DAG."""

    def __init__(self, heads: List[Tuple[_Node, int]]):
        self._heads = heads

    @property
    def name(self) -> str:
        return self._heads[0][0].name if len(self._heads) == 1 else "group"

    def __repr__(self):
        return f"<Symbol {self.name}>"

    def __iter__(self):
        for i in range(len(self._heads)):
            yield self[i]

    def __len__(self):
        return len(self._heads)

    def __getitem__(self, idx):
        if isinstance(idx, str):
            names = self.list_outputs()
            if idx not in names:
                raise MXNetError(f"no output named {idx!r}")
            idx = names.index(idx)
        if isinstance(idx, slice):
            return Symbol(self._heads[idx])
        return Symbol([self._heads[idx]])

    def __call__(self, *args, name=None, **kwargs):
        """Late composition (reference `symbol.py:__call__`): this graph
        with its free variables replaced by the given one-output symbols,
        positionally in variable order or by name (not both).  ``name``
        renames the composed head node.  This symbol is unchanged."""
        if args and kwargs:
            raise MXNetError(
                "compose only accepts input Symbols either as positional "
                "or keyword arguments, not both")

        def entry_of(key, sym):
            if not isinstance(sym, Symbol):
                raise MXNetError(f"compose: {key} must be a Symbol, got "
                                 f"{type(sym).__name__}")
            if len(sym._heads) != 1:
                raise MXNetError(
                    f"compose: {key} must have exactly one output, has "
                    f"{len(sym._heads)}")
            return sym._heads[0]

        subs: Dict[str, Tuple[_Node, int]] = {}
        free = [n for n in self._nodes() if n.is_var]
        free_names = {n.name for n in free}
        if len(args) > len(free):
            raise MXNetError(f"compose: {len(args)} args for {len(free)} "
                             "free variables")
        for var_node, sym in zip(free, args):
            subs[var_node.name] = entry_of(var_node.name, sym)
        for key, sym in kwargs.items():
            if key not in free_names:
                raise MXNetError(f"compose: no free variable {key!r}")
            subs[key] = entry_of(key, sym)
        if not subs and name is None:
            return Symbol(list(self._heads))

        touched: Dict[int, bool] = {}
        for node in self._nodes():
            touched[id(node)] = (node.name in subs if node.is_var else
                                 any(touched[id(i)] for (i, _) in node.inputs))
        memo: Dict[int, _Node] = {}
        for node in self._nodes():
            if node.is_var or not touched[id(node)]:
                memo[id(node)] = node  # an untouched subgraph is shared
                continue
            memo[id(node)] = _Node(node.op, node.name, dict(node.attrs), [
                subs[i.name] if i.is_var and i.name in subs
                else (memo[id(i)], k) for (i, k) in node.inputs])
        heads = [subs[n.name] if n.is_var and n.name in subs
                 else (memo[id(n)], i) for (n, i) in self._heads]
        if name is not None and len(heads) == 1 and not heads[0][0].is_var:
            top, idx = heads[0]
            if any(top is n for (n, _) in self._heads):
                # an untouched head is copied, so that the rename leaves
                # this graph as it was
                top = _Node(top.op, top.name, dict(top.attrs),
                            list(top.inputs))
            top.name = name
            heads[0] = (top, idx)
        return Symbol(heads)

    # -- composition sugar --------------------------------------------------
    def _binop(self, other, op, scalar_op, reverse=False):
        """``self op other``: a broadcast node for a Symbol, a scalar node
        (the reversed one where ``reverse``) for a number."""
        from .register import invoke_sym  # register imports this module
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return invoke_sym(op, a, b)
        if isinstance(other, (int, float, bool, np.number)):
            name = _REVERSE_SCALAR.get(scalar_op, scalar_op) if reverse \
                else scalar_op
            return invoke_sym(name, self, scalar=float(other))
        return NotImplemented

    def __add__(self, o):
        return self._binop(o, "broadcast_add", "_plus_scalar")

    def __radd__(self, o):
        return self._binop(o, "broadcast_add", "_plus_scalar", True)

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar", True)

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul", "_mul_scalar")

    def __rmul__(self, o):
        return self._binop(o, "broadcast_mul", "_mul_scalar", True)

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar", True)

    def __pow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar")

    def __mod__(self, o):
        return self._binop(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._binop(o, "broadcast_mod", "_mod_scalar", True)

    def __eq__(self, o):
        if isinstance(o, (Symbol, int, float, np.number)):
            return self._binop(o, "broadcast_equal", "_equal_scalar")
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (Symbol, int, float, np.number)):
            return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")
        return NotImplemented

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def __neg__(self):
        from .register import invoke_sym
        return invoke_sym("negative", self)

    # -- listing ----------------------------------------------------------
    def _nodes(self) -> List[_Node]:
        return _topo(self._heads)

    def _aux_var_names(self) -> set:
        """Variables every consumer of which mutates them (MXNet's
        FMutateInputs, e.g. BatchNorm's moving statistics): the graph's
        auxiliary states."""
        consumers: Dict[str, List[bool]] = {}
        for node in self._nodes():
            if node.is_var:
                continue
            mut = _reg.get_op(node.op).mutate_slots(
                Attrs(strip_annotations(node.attrs)))
            for slot, (inp, _) in enumerate(node.inputs):
                if inp.is_var:
                    consumers.setdefault(inp.name, []).append(slot in mut)
        return {name for name, slots in consumers.items()
                if slots and all(slots)}

    def get_internals(self) -> "Symbol":
        """Every output of every node, variables included, as one group
        (reference `symbol.py:get_internals`)."""
        return Symbol([(node, i) for node in self._nodes()
                       for i in range(node.num_outputs)])

    def list_arguments(self) -> List[str]:
        aux = self._aux_var_names()
        return [n.name for n in self._nodes() if n.is_var
                and n.name not in aux]

    def list_auxiliary_states(self) -> List[str]:
        aux = self._aux_var_names()
        return [n.name for n in self._nodes() if n.is_var and n.name in aux]

    def list_inputs(self) -> List[str]:
        """Every variable, arguments and auxiliary states alike."""
        return [n.name for n in self._nodes() if n.is_var]

    def get_children(self) -> Optional["Symbol"]:
        """The inputs of the head nodes (a node with several heads counts
        once), or None for a variable."""
        heads, seen = [], set()
        for (node, _) in self._heads:
            if id(node) in seen:
                continue
            seen.add(id(node))
            heads.extend(node.inputs)
        return Symbol(heads) if heads else None

    def list_outputs(self) -> List[str]:
        out = []
        for (node, idx) in self._heads:
            if node.is_var:
                out.append(node.name)
            elif node.num_outputs == 1:
                out.append(f"{node.name}_output")
            else:
                out.append(f"{node.name}_output{idx}")
        return out

    # -- attributes ---------------------------------------------------------
    def attr_dict(self):
        """Node name -> its attrs as strings, for the nodes that have any
        (reference `symbol.py:attr_dict()`)."""
        return {n.name: {k: _attr_str(v) for k, v in n.attrs.items()}
                for n in self._nodes() if n.attrs}

    def attr(self, key):
        """An attr of the head node as a string, under its plain or its
        dunder spelling (``attr('lr_mult') == attr('__lr_mult__')``)."""
        if len(self._heads) != 1:
            return None
        attrs = self._heads[0][0].attrs
        v = attrs.get(key)
        if v is None and key.startswith("__") and key.endswith("__"):
            v = attrs.get(key[2:-2])
        elif v is None:
            v = attrs.get(f"__{key}__")
        return _attr_str(v) if v is not None else None

    def list_attr(self, recursive=False):
        """The head node's attrs as strings; ``recursive`` is `attr_dict`
        now, and raises as the reference does."""
        if recursive:
            raise DeprecationWarning(
                "Symbol.list_attr with recursive=True has been deprecated. "
                "Please use attr_dict instead.")
        if len(self._heads) != 1:
            return {}
        return {k: _attr_str(v) for k, v in self._heads[0][0].attrs.items()}

    # -- shape and type inference -----------------------------------------

    def infer_shape(self, **shapes):
        """``(arg_shapes, out_shapes, aux_shapes)`` from known input
        shapes; raises when an argument stays unresolved."""
        return self._infer_shape_impl(False, shapes)

    def infer_shape_partial(self, **shapes):
        """`infer_shape` leaving unresolved entries as None."""
        return self._infer_shape_impl(True, shapes)

    def _infer_shape_impl(self, partial, shapes):
        known = {k: tuple(v) for k, v in shapes.items() if v is not None}
        inferred, _ = _infer_graph(self._heads, known, partial)
        arg_shapes = [inferred.get(n) for n in self.list_arguments()]
        out_shapes = [inferred.get(_value_key(e)) for e in self._heads]
        aux_shapes = [inferred.get(n) for n in self.list_auxiliary_states()]
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """``(arg_types, out_types, aux_types)`` as numpy dtypes
        (``torch.bfloat16`` for bfloat16, which numpy lacks, as an
        NDArray's ``dtype``), from the known inputs' dtypes (positional
        in `list_arguments` order, or by name): each node's output takes
        its ``dtype`` attr, else the promotion of its inputs' dtypes, and
        an unknown variable input adopts what the node's known inputs
        agree on (the JAX package's propagation)."""
        known: Dict[str, Any] = {}
        arg_names = self.list_arguments()
        for name, t in zip(arg_names, args):
            if t is not None:
                known[name] = _type_of(t)
        known.update({k: _type_of(v) for k, v in kwargs.items()
                      if v is not None})
        dtypes: Dict[str, Any] = {}
        for node in self._nodes():
            if node.is_var:
                if node.name in known:
                    dtypes[node.name] = known[node.name]
                else:
                    forced = Attrs(node.attrs).get_dtype("__dtype__", None)
                    if forced is not None:
                        dtypes[node.name] = _type_of(forced)
                continue
            keys = [(_value_key(e), e[0].is_var) for e in node.inputs]
            in_dts = [dtypes.get(k) for k, _ in keys]
            resolved = [d for d in in_dts if d is not None]
            fill = (_result_type(resolved) if resolved
                    else np.dtype(np.float32))
            for (k, is_var), d in zip(keys, in_dts):
                if d is None and is_var:
                    dtypes[k] = fill
            forced = Attrs(node.attrs).get_dtype("dtype", None)
            out_dt = _type_of(forced) if forced is not None else fill
            for i in range(node.num_outputs):
                dtypes[_entry_key((node, i))] = out_dt
        f32 = np.dtype(np.float32)
        return ([dtypes.get(n, f32) for n in arg_names],
                [dtypes.get(_value_key(e)) for e in self._heads],
                [dtypes.get(n, f32) for n in self.list_auxiliary_states()])

    def infer_type_partial(self, *args, **kwargs):
        """`infer_type`, which already tolerates unknown inputs."""
        return self.infer_type(*args, **kwargs)

    # -- what only an NDArray does ------------------------------------------
    def gradient(self, wrt):
        """Not implemented, as in the reference: gradients come from an
        executor's backward or from autograd."""
        raise NotImplementedError(
            "Symbol.gradient is not implemented (same as the reference); "
            "use executor.backward or autograd")

    def get_backend_symbol(self, backend):
        """This graph partitioned by the named subgraph property
        (reference `symbol.py:get_backend_symbol`; `subgraph.py`)."""
        from ..subgraph import get_subgraph_property, partition
        return partition(self, get_subgraph_property(backend))

    def astype(self, dtype=None, **kwargs):
        """``sym.cast(self, dtype=...)``."""
        from .register import invoke_sym
        if dtype is not None:
            kwargs.setdefault("dtype", dtype)
        return invoke_sym("cast", self, **kwargs)

    def _nifs(self, fn, alias=None):
        raise NotImplementedForSymbol(fn, alias)

    def wait_to_read(self):
        self._nifs(self.wait_to_read)

    def asnumpy(self):
        self._nifs(self.asnumpy)

    def asscalar(self):
        self._nifs(self.asscalar)

    def copy(self):
        self._nifs(self.copy)

    def as_in_context(self, context):
        self._nifs(self.as_in_context)

    def detach(self):
        self._nifs(self.detach)

    def backward(self):
        self._nifs(self.backward)

    def __bool__(self):
        raise NotImplementedForSymbol(self.__bool__, "bool")

    # -- serialization ------------------------------------------------------
    def tojson_dict(self):
        return json.loads(self.tojson())

    def debug_str(self):
        """One line per node, inputs first: its op (``Variable``), name and
        inputs."""
        lines = []
        for n in self._nodes():
            kind = "Variable" if n.is_var else n.op
            ins = ", ".join(f"{s.name}[{i}]" for (s, i) in n.inputs)
            lines.append(f"{kind} {n.name}({ins})")
        return "\n".join(lines)

    def tojson(self) -> str:
        nodes = self._nodes()
        nid = {id(n): i for i, n in enumerate(nodes)}
        graph = {
            "nodes": [{
                "op": "null" if n.is_var else n.op,
                "name": n.name,
                "attrs": {k: _attr_str(v) for k, v in n.attrs.items()},
                "inputs": [[nid[id(s)], i, 0] for (s, i) in n.inputs],
            } for n in nodes],
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_var],
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": [[nid[id(n)], i, 0] for (n, i) in self._heads],
            "attrs": {"mxnet_version": ["int", 10400]},
        }
        return json.dumps(graph, indent=2)

    def save(self, fname: str) -> None:
        """Write `tojson` to ``fname``."""
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- execution ----------------------------------------------------------
    def eval(self, ctx=None, **kwargs):
        """The outputs for the input arrays ``kwargs`` (a bind and one
        forward)."""
        return self.bind(ctx, args=kwargs, grad_req="null").forward()

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An `Executor` over this graph with ``args`` bound (and, where
        ``args_grad`` gives buffers, their gradients per ``grad_req``).
        ``MXNET_SUBGRAPH_BACKEND`` partitions the graph first, unless
        ``group2ctx`` places its groups (`Executor`); positional lists
        stay aligned to this symbol's order.  ``shared_exec`` is accepted
        as the reference accepts it: the arrays given are the storage."""
        from ..executor import Executor  # the executor imports symbols
        from ..subgraph import apply_env_backend
        part = self if group2ctx else apply_env_backend(self)
        if part is not self:
            arg_names = self.list_arguments()
            if isinstance(args, (list, tuple)):
                args = dict(zip(arg_names, args))
            if isinstance(args_grad, (list, tuple)):
                args_grad = dict(zip(arg_names, args_grad))
            if isinstance(grad_req, (list, tuple)):
                grad_req = dict(zip(arg_names, grad_req))
            if isinstance(aux_states, (list, tuple)):
                aux_states = dict(zip(self.list_auxiliary_states(),
                                      aux_states))
        return Executor(part, ctx, args=args, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux_states,
                        group2ctx=group2ctx)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, **shapes):
        """Bind with every argument, gradient and auxiliary state
        allocated as zeros on ``ctx`` (the card when none is given), their
        shapes inferred from the given input ``shapes`` (reference
        `symbol.py:1369`).  ``type_dict`` names dtypes other than
        float32; the arguments it does not name take the float dtype
        `infer_type` propagates to them.  ``MXNET_SUBGRAPH_BACKEND``
        partitions the graph first, unless ``group2ctx`` is given: then
        each array is allocated in its group's context
        (`executor.group_placement`).  ``shared_exec`` lends its arrays:
        each argument (but the inputs ``shapes`` names), gradient and
        auxiliary state it holds is bound as the same array, not a copy,
        and a shape that differs raises ValueError."""
        from ..executor import Executor, group_placement
        from ..ndarray.ndarray import zeros
        from ..subgraph import apply_env_backend
        if not group2ctx:
            self = apply_env_backend(self)
        if ctx is None:
            ctx = default_context("simple_bind")
        arg_shapes, _, aux_shapes = self.infer_shape(**shapes)
        type_dict = dict(type_dict or {})
        # the other arguments take the float dtype `infer_type` gives them
        # (float64 data, float64 weights), as in the JAX package
        arg_types, _, aux_types = self.infer_type(**type_dict)

        def dtype(name, inferred):
            if name in type_dict:
                return type_dict[name]
            return inferred if inferred is torch.bfloat16 or \
                np.issubdtype(inferred, np.floating) else "float32"

        var_ctx = group_placement(self, group2ctx)
        args = {n: zeros(s, ctx=var_ctx.get(n, ctx), dtype=dtype(n, t))
                for n, s, t in zip(self.list_arguments(), arg_shapes,
                                   arg_types)}
        aux = {n: zeros(s, ctx=var_ctx.get(n, ctx), dtype=dtype(n, t))
               for n, s, t in zip(self.list_auxiliary_states(), aux_shapes,
                                  aux_types)}
        args_grad = None
        if grad_req != "null":
            args_grad = {n: zeros(a.shape, ctx=a.context, dtype=a._tdtype)
                         for n, a in args.items()}
        if shared_exec is not None:
            _share_arrays(shared_exec, args, args_grad, aux, set(shapes))
        ex = Executor(self, ctx, args=args, args_grad=args_grad,
                      grad_req=grad_req, aux_states=aux, group2ctx=group2ctx)
        # the same arrays, not new handles over their tensors
        ex.arg_dict.update(args)
        ex.aux_dict.update(aux)
        if args_grad is not None:
            ex.grad_dict.update({n: g for n, g in args_grad.items()
                                 if n in ex.grad_dict})
        return ex


def _share_arrays(src, args, args_grad, aux, inputs) -> None:
    """Put ``src``'s parameter arrays (its arguments but ``inputs``, their
    gradients, its auxiliary states) in place of the new ones in
    ``args``, ``args_grad`` and ``aux``; a shape that differs raises
    ValueError, since a parameter left at zeros would pass unnoticed."""
    for what, mine, theirs in (("parameter", args, src.arg_dict),
                               ("aux state", aux, src.aux_dict)):
        for name, arr in theirs.items():
            if name in inputs or name not in mine:
                continue
            if tuple(arr.shape) != tuple(mine[name].shape):
                raise ValueError(
                    f"shared_module: {what} {name!r} shape "
                    f"{tuple(arr.shape)} does not match this module's "
                    f"{tuple(mine[name].shape)}")
            mine[name] = arr
            if what == "parameter" and args_grad is not None \
                    and name in args_grad and name in src.grad_dict:
                args_grad[name] = src.grad_dict[name]


#: the op that computes ``scalar op x`` for a scalar op of ``x op scalar``
_REVERSE_SCALAR = {
    "_minus_scalar": "_rminus_scalar",
    "_div_scalar": "_rdiv_scalar",
    "_mod_scalar": "_rmod_scalar",
    "_power_scalar": "_rpower_scalar",
}


def _attr_str(v) -> str:
    """The JAX package's JSON spelling of an attr value."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            # trailing comma so the string parses back to a 1-tuple
            return "(" + str(v[0]) + ",)"
        return "(" + ", ".join(str(x) for x in v) + ")"
    return str(v)


def _var_shape(node: _Node) -> Optional[tuple]:
    """A variable's declared ``__shape__`` (0 marks an unknown dim)."""
    raw = node.attrs.get("__shape__")
    if raw is None:
        return None
    return tuple(str_to_attr(raw) if isinstance(raw, str) else raw)


def _punify(a, b):
    """Two partial shapes (0 an unknown dim) merged into one; raises on a
    conflict."""
    if a is None:
        return tuple(b)
    if b is None:
        return tuple(a)
    if len(a) != len(b):
        raise MXNetError(f"shape rank mismatch: {a} vs {b}")
    out = []
    for x, y in zip(a, b):
        if x == 0:
            out.append(y)
        elif y == 0 or x == y:
            out.append(x)
        else:
            raise MXNetError(f"incompatible shapes: {a} vs {b}")
    return tuple(out)


_PARTIAL_BINARY = ("broadcast_add", "broadcast_sub", "broadcast_mul",
                   "broadcast_div", "elemwise_add", "elemwise_sub",
                   "elemwise_mul", "elemwise_div", "_Plus", "_plus")


def _partial_updates(node, get, attrs):
    """``{value key: partial shape}``: what the partial-shape rules of the
    core op families (the reference's InferShape of
    `elemwise_op_common.h`, `fully_connected.cc`, `slice_channel.cc`,
    `convolution.cc`, `concat.cc`) learn of ``node``'s inputs and outputs,
    forward and backward, from the partial shapes ``get(key)`` gives."""
    op = node.op
    ups: Dict[str, tuple] = {}
    in_keys = [_value_key(e) for e in node.inputs]
    out0 = _entry_key((node, 0))

    def merge(key, new):
        cur = get(key)
        try:
            uni = _punify(cur, new)
        except MXNetError:
            raise MXNetError(
                f"shape inference failed at node {node.name} ({op}): "
                f"{cur} vs {new}")
        if uni != (tuple(cur) if cur is not None else None):
            ups[key] = uni

    if op in _PARTIAL_BINARY and len(in_keys) == 2:
        # as the reference's broadcast rule, an unknown dim is filled from
        # the other operand or from the output
        sa, sb = get(in_keys[0]), get(in_keys[1])
        so = get(out0)
        if sa is not None and sb is not None and len(sa) == len(sb):
            o = []
            for x, y in zip(sa, sb):
                if x == y or y in (0, 1):
                    o.append(x)
                elif x in (0, 1):
                    o.append(y)
                else:
                    raise MXNetError(
                        f"shape inference failed at node {node.name} "
                        f"({op}): incompatible shapes {sa} vs {sb}")
            merge(out0, tuple(o))
        if so is not None:
            for k, sh in ((in_keys[0], sa), (in_keys[1], sb)):
                if sh is not None and len(sh) == len(so):
                    merge(k, tuple(si if si == 1 and oi != 1 else oi
                                   if si == 0 else si
                                   for si, oi in zip(sh, so)))
        return ups
    if op == "FullyConnected":
        num_hidden = attrs.get_int("num_hidden", 0)
        sd, so = get(in_keys[0]), get(out0)
        if sd is not None and len(sd) == 2:
            merge(out0, (sd[0], num_hidden))
        if so is not None and len(so) == 2 and sd is not None \
                and len(sd) == 2:
            merge(in_keys[0], (so[0], sd[1]))
        return ups
    if op == "Activation" or op in ("relu", "sigmoid", "tanh", "softsign"):
        si, so = get(in_keys[0]), get(out0)
        if si is not None:
            merge(out0, si)
        if so is not None:
            merge(in_keys[0], so)
        return ups
    if op == "SliceChannel":
        k = attrs.get_int("num_outputs", 1)
        ax = attrs.get_int("axis", 1)
        squeeze = attrs.get_bool("squeeze_axis", False)
        si = get(in_keys[0])
        known_out = None
        for o in (get(_entry_key((node, i))) for i in range(k)):
            if o is not None:
                known_out = _punify(known_out, o)
        if known_out is not None:
            for i in range(k):
                merge(_entry_key((node, i)), known_out)
        if si is not None:
            ax_ = ax % len(si)
            if si[ax_] and si[ax_] % k != 0:
                raise MXNetError(
                    f"SliceChannel: axis {ax} size {si[ax_]} not "
                    f"divisible by num_outputs={k}")
            if squeeze and si[ax_] and si[ax_] != k:
                raise MXNetError(
                    f"SliceChannel: squeeze_axis requires axis size "
                    f"{si[ax_]} == num_outputs={k}")
            per = si[ax_] // k if si[ax_] else 0
            o = (si[:ax_] + ((per,) if not squeeze else ())
                 + si[ax_ + 1:])
            for i in range(k):
                merge(_entry_key((node, i)), o)
        if known_out is not None:
            if squeeze:
                ax_ = ax % (len(known_out) + 1)
                inp = known_out[:ax_] + (k,) + known_out[ax_:]
            else:
                ax_ = ax % len(known_out)
                inp = (known_out[:ax_] + (known_out[ax_] * k,)
                       + known_out[ax_ + 1:])
            merge(in_keys[0], inp)
        return ups
    if op == "Convolution":
        kern = attrs.get_tuple("kernel", None) or ()
        if len(kern) != 2 or attrs.get_str("layout", "None") not in (
                "None", "NCHW"):
            return ups
        stride = attrs.get_tuple("stride", None) or (1, 1)
        pad = attrs.get_tuple("pad", None) or (0, 0)
        dil = attrs.get_tuple("dilate", None) or (1, 1)
        nf = attrs.get_int("num_filter", 0)
        si, so = get(in_keys[0]), get(out0)

        def fwd(d, i):
            if not d:
                return 0
            eff = dil[i] * (kern[i] - 1) + 1
            return (d + 2 * pad[i] - eff) // stride[i] + 1

        def bwd(d, i):
            # exact at stride 1 only: a larger stride maps several input
            # sizes to one output size
            if not d or stride[i] != 1:
                return 0
            eff = dil[i] * (kern[i] - 1) + 1
            return (d - 1) * stride[i] + eff - 2 * pad[i]

        if si is not None and len(si) == 4:
            merge(out0, (si[0], nf, fwd(si[2], 0), fwd(si[3], 1)))
        if so is not None and len(so) == 4:
            cur_in = si if si is not None else (0, 0, 0, 0)
            merge(in_keys[0], (so[0], cur_in[1] if len(cur_in) == 4
                               else 0, bwd(so[2], 0), bwd(so[3], 1)))
        return ups
    if op == "Concat":
        dim = attrs.get_int("dim", 1)
        ins = [get(k) for k in in_keys]
        so = get(out0)
        ref = next((sh for sh in ins if sh is not None), None)
        if ref is not None:
            dim_ = dim % len(ref)
            if any(sh is not None and len(sh) != len(ref) for sh in ins):
                raise MXNetError(
                    f"Concat: rank mismatch across inputs "
                    f"{[sh for sh in ins if sh is not None]}")
            tot = sum(sh[dim_] for sh in ins) \
                if all(sh is not None and sh[dim_] for sh in ins) else 0
            o = list(ref)
            for sh in ins:
                if sh is not None:
                    for i, v in enumerate(sh):
                        if i != dim_ and v and not o[i]:
                            o[i] = v
            o[dim_] = tot
            merge(out0, tuple(o))
        if so is not None:
            dim_ = dim % len(so)
            for k, sh in zip(in_keys, ins):
                if sh is not None and len(sh) != len(so):
                    raise MXNetError(
                        f"Concat: rank mismatch {sh} vs output {so}")
                want = list(so)
                want[dim_] = sh[dim_] if sh is not None else 0
                merge(k, tuple(want))
        return ups
    return ups


def _infer_graph(heads, known: Dict[str, tuple], partial: bool,
                 known_dtypes: Optional[Dict[str, torch.dtype]] = None):
    """``({value key -> shape}, {value key -> dtype})`` for every entry
    this pass can resolve: each op runs on meta tensors once all its
    inputs are known; parameter inputs are back-filled from data shapes
    first (the reference's bidirectional InferShape for the layered ops).
    Where that stalls and a shape holds unknown (0) dims, the partial
    rules (`_partial_updates`) fill them from the other operand or the
    output, and the exact pass resumes, checking what they predicted.
    A variable's dtype is float32 unless ``known_dtypes`` names it."""
    nodes = _topo(heads)
    known_dtypes = known_dtypes or {}
    shapes: Dict[str, Optional[tuple]] = {}
    partials: Dict[str, tuple] = {}
    predicted: set = set()   # resolved by the partial rules, not yet run
    dtypes: Dict[str, torch.dtype] = {}
    for n in nodes:
        if n.is_var:
            shape = known[n.name] if n.name in known else _var_shape(n)
            if shape is not None and 0 in shape:
                partials[n.name] = tuple(shape)
                shape = None
            shapes[n.name] = shape
            dtypes[n.name] = known_dtypes.get(n.name, torch.float32)
    progress = True
    while progress:
        progress = False
        for node in nodes:
            if node.is_var:
                continue
            out0 = _entry_key((node, 0))
            keys = [_value_key(e) for e in node.inputs]
            if out0 in shapes and out0 not in predicted:
                continue
            if any(shapes.get(k) is None for k in keys):
                for vname, shp in infer_param_shapes(node, shapes).items():
                    if shapes.get(vname) is None:
                        shapes[vname] = shp
                        progress = True
            in_shapes = [shapes.get(k) for k in keys]
            if any(s is None for s in in_shapes):
                continue
            try:
                out_shapes, out_dtypes = _reg.eval_shape_op(
                    node.op, in_shapes,
                    [dtypes.get(k, torch.float32) for k in keys],
                    strip_annotations(node.attrs))
            except Exception as e:
                raise MXNetError(f"shape inference failed at node "
                                 f"{node.name} ({node.op}): {e}") from e
            for i, (s, d) in enumerate(zip(out_shapes, out_dtypes)):
                key = _entry_key((node, i))
                prev = shapes.get(key)
                if prev is not None and tuple(prev) != tuple(s):
                    raise MXNetError(
                        f"shape inference failed at node {node.name} "
                        f"({node.op}): partial {prev} vs evaluated {s}")
                shapes[key] = s
                dtypes[key] = d
                predicted.discard(key)
            progress = True
        if not progress and partials:
            def get(key):
                s = shapes.get(key)
                return s if s is not None else partials.get(key)

            for node in nodes:
                if node.is_var:
                    continue
                attrs = Attrs(strip_annotations(node.attrs))
                for key, new in _partial_updates(node, get, attrs).items():
                    if 0 in new:
                        partials[key] = new
                    else:
                        partials.pop(key, None)
                        if shapes.get(key) is None:
                            shapes[key] = new
                            predicted.add(key)
                    progress = True
    missing = [n.name for n in nodes if n.is_var and shapes.get(n.name) is None]
    if missing and not partial:
        raise MXNetError(f"infer_shape: unresolved arguments {missing}")
    return shapes, dtypes


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def var(name: str, shape=None, dtype=None, init=None, lr_mult=None,
        wd_mult=None, **kwargs) -> Symbol:
    """A variable symbol: ``shape``, ``dtype``, ``init``, ``lr_mult`` and
    ``wd_mult`` become its ``__shape__``, ``__dtype__``, ``__init__`` (the
    initializer's JSON), ``__lr_mult__`` and ``__wd_mult__`` attrs, and
    other keywords (``stype``, ``attr={...}``) plain attrs, as in the JAX
    package.  A sparse ``stype`` is a note: the bound array is dense, and
    a sparse input is densified when fed."""
    attrs: Dict[str, Any] = {}
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype)
    if init is not None:
        attrs["__init__"] = init.dumps() if hasattr(init, "dumps") \
            else str(init)
    if lr_mult is not None:
        attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attrs["__wd_mult__"] = str(wd_mult)
    attrs.update(kwargs.pop("attr", None) or {})
    attrs.update({k: v for k, v in kwargs.items() if v is not None})
    attrs = _attr_scope().get(attrs)
    return Symbol([(_Node(None, name, attrs, []), 0)])


Variable = var


def Group(symbols: Sequence[Symbol]) -> Symbol:
    heads = []
    for s in symbols:
        heads.extend(s._heads)
    return Symbol(heads)


def _upgrade_legacy_json(graph: dict) -> dict:
    """Pre-1.0 symbol JSON, upgraded in place (reference
    `src/nnvm/legacy_json_util.cc`): a node's ``param`` (op parameters)
    and ``attr`` (user attributes) merge into ``attrs``, 2-wide
    ``inputs``/``heads`` entries get their version field, and the ``*_v1``
    op spellings become today's ops."""
    for nj in graph.get("nodes", []):
        legacy = {}
        for key in ("param", "attr"):
            d = nj.pop(key, None)
            if d:
                legacy.update(d)
        if legacy:
            nj["attrs"] = {**legacy, **(nj.get("attrs") or {})}
        nj["inputs"] = [list(e) + [0] * (3 - len(e))
                        for e in nj.get("inputs", [])]
        if nj.get("op") in _LEGACY_OP_RENAMES:
            nj["op"] = _LEGACY_OP_RENAMES[nj["op"]]
    heads = graph.get("heads") or graph.get("head") or []
    graph["heads"] = [list(e) + [0] * (3 - len(e)) for e in heads]
    return graph


#: the ``*_v1`` ops of old model files, served by today's ops
_LEGACY_OP_RENAMES = {
    "BatchNorm_v1": "BatchNorm",
    "Convolution_v1": "Convolution",
    "Pooling_v1": "Pooling",
    "Flatten_v1": "Flatten",
    "Concat_v1": "Concat",
    "Dropout_v1": "Dropout",
}


def load_json(json_str: str) -> Symbol:
    graph = _upgrade_legacy_json(json.loads(json_str))
    built: List[_Node] = []
    for nj in graph["nodes"]:
        inputs = [(built[i[0]], i[1]) for i in nj.get("inputs", [])]
        op = None if nj["op"] == "null" else nj["op"]
        built.append(_Node(op, nj["name"], dict(nj.get("attrs") or {}),
                           inputs))
    return Symbol([(built[h[0]], h[1]) for h in graph["heads"]])


def load(fname: str) -> Symbol:
    """The Symbol of a JSON file (`Symbol.save`, `HybridBlock.export`)."""
    with open(fname) as f:
        return load_json(f.read())


def _new_op_node(op_name: str, inputs: List[Tuple[_Node, int]],
                 attrs: Dict[str, Any], name: Optional[str]) -> Symbol:
    if name is None:
        name = _NAMES.get(op_name.lstrip("_"))
    node = _Node(op_name, name, _attr_scope().get(attrs), inputs)
    return Symbol([(node, i) for i in range(node.num_outputs)])
