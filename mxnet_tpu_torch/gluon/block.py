"""Gluon Block and HybridBlock (the counterpart of `mxnet_tpu/gluon/block.py`;
reference `python/mxnet/gluon/block.py`).

Names follow the reference: a block without a ``prefix`` gets
``<class name lower-cased><n>_``, counted per parent for children and per
process for top-level blocks, and its parameters are named under it, so
one model function names its parameters alike in both packages.  A
HybridBlock's ``hybrid_forward(F, x, **params)`` runs with ``F = nd`` on
NDArrays and ``F = sym`` on Symbols (`export`, the Symbol tracer).
``hybridize()`` routes NDArray calls through a `cached_op.CachedOp`: on
the card a predict-mode forward is captured as a CUDA graph per input
signature, and a forward recorded in train mode as a forward and a
backward graph (one node on torch's tape).  `SymbolBlock` wraps a Symbol
graph (a loaded export, or `get_internals` of a net) as a Block.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, load_into)

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope(threading.local):
    def __init__(self):
        super().__init__()
        self.current = None
        self.counters = {}


_scope = _BlockScope()


def _make_prefix(hint, parent=None):
    """``<hint><n>_``: counted per parent scope for children (reference
    `_BlockScope._counter`), per process for top-level blocks."""
    if parent is not None:
        counters = parent.__dict__.setdefault("_child_counters", {})
    else:
        counters = _scope.counters
    idx = counters.get(hint, 0)
    counters[hint] = idx + 1
    return f"{hint}{idx}_"


class _NameScope:
    """``with block.name_scope():`` -- children created inside are named
    under ``block``; a no-op for a block made with ``prefix=""``, whose
    parent's scope stays current (reference `block.py:48-56`)."""

    def __init__(self, block):
        self._block = block

    def __enter__(self):
        if not self._block._empty_prefix:
            self._old = _scope.current
            _scope.current = self._block
        return self

    def __exit__(self, *exc):
        if not self._block._empty_prefix:
            _scope.current = self._old


class _HookHandle:
    """A registered hook; ``detach()`` removes it."""

    def __init__(self, hooks, hook):
        self._hooks = hooks
        self._hook = hook

    def detach(self):
        if self._hook is not None and self._hook in self._hooks:
            self._hooks.remove(self._hook)
        self._hook = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.detach()


class Block:
    """Base of all layers and models (reference `block.py:127`)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        hint = type(self).__name__.lower()
        parent = _scope.current
        if prefix is None:
            prefix = _make_prefix(hint, parent)
        if params is not None:
            param_prefix, shared = params.prefix, params
        elif parent is not None:
            param_prefix = parent.params.prefix + prefix
            shared = parent.params._shared
        else:
            param_prefix, shared = prefix, None
        if parent is not None:
            prefix = parent.prefix + prefix
        self._prefix = prefix
        self._params = ParameterDict(param_prefix, shared=shared)
        self._children = OrderedDict()
        self._reg_params = {}
        self._forward_hooks = []
        self._forward_pre_hooks = []

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix

    @property
    def params(self):
        return self._params

    def name_scope(self):
        return _NameScope(self)

    def collect_params(self, select=None) -> ParameterDict:
        """This block's and its descendants' parameters, those whose name
        matches the regex ``select`` when given."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self._params)
        else:
            pat = re.compile(select)
            ret.update({k: v for k, v in self._params.items()
                        if pat.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select))
        return ret

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            children = self.__dict__.get("_children")
            if children is not None:
                children[name] = value
        elif isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is not None:
                reg[name] = value
                self._params._params[value.name] = value
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        self._children[name or str(len(self._children))] = block

    def register_forward_hook(self, hook):
        self._forward_hooks.append(hook)
        return _HookHandle(self._forward_hooks, hook)

    def register_forward_pre_hook(self, hook):
        self._forward_pre_hooks.append(hook)
        return _HookHandle(self._forward_pre_hooks, hook)

    def apply(self, fn):
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (the card when none is
        given)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def _collect_params_with_prefix(self, prefix=""):
        """Parameters by structural name (``features.0.weight``), the
        keying of `save_parameters` files."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename):
        """The `.params` file of this block's parameters by structural
        name (reference `block.py:315`)."""
        from ..serialization import save_ndarrays
        params = self._collect_params_with_prefix()
        save_ndarrays(filename, {k: v.data() for k, v in params.items()
                                 if v._data is not None})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """Load a `save_parameters` file (structural names) or an `export`
        file (``arg:``/``aux:``-prefixed full names)."""
        from ..serialization import load_ndarrays, strip_arg_aux
        loaded, had_prefixes = strip_arg_aux(load_ndarrays(filename))
        params = (dict(self.collect_params().items()) if had_prefixes
                  else self._collect_params_with_prefix())
        load_into(params, loaded, ctx, allow_missing, ignore_extra)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for p in self._params.values():
            p.cast(dtype)

    def __call__(self, *args):
        from ..cached_op import is_tracing
        hooks = (self._forward_pre_hooks or self._forward_hooks) \
            and not is_tracing()
        if hooks:
            for hook in self._forward_pre_hooks:
                hook(self, args)
        out = self.forward(*args)
        if hooks:
            for hook in self._forward_hooks:
                hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def summary(self, *inputs):
        """Each block's name, output shape and parameter count for one
        forward of ``inputs``, as text (reference `block.py:summary`)."""
        lines = [f"{'Layer':<40}{'Output shape':<24}{'#Params':<12}"]
        handles = []

        def hook(b, inp, out):
            o = out[0] if isinstance(out, (list, tuple)) else out
            nparam = sum(p.data().size for p in b._reg_params.values()
                         if p._data is not None)
            lines.append(f"{b.name:<40}{str(getattr(o, 'shape', '?')):<24}"
                         f"{nparam:<12}")

        self.apply(lambda blk:
                   handles.append(blk.register_forward_hook(hook)))
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.detach()
        return "\n".join(lines)

    def __repr__(self):
        lines = [type(self).__name__ + "("]
        for name, child in self._children.items():
            c = repr(child).replace("\n", "\n  ")
            lines.append(f"  ({name}): {c}")
        lines.append(")")
        return "\n".join(lines)


class HybridBlock(Block):
    """A block whose forward is written once for NDArrays and Symbols
    (reference `block.py:671`)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False
        self._cached_op = None

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Run NDArray calls through a `CachedOp` from the next call on
        (reference `block.py:hybridize`); ``static_alloc`` and
        ``static_shape`` are accepted: a captured graph has both."""
        self._active = active
        self._cached_op = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def _ensure_init(self, args):
        """Deferred initialization: set the parameters' shapes from the
        inputs (`infer_shape`), then draw their values."""
        try:
            for p in self._reg_params.values():
                p._check_and_get()
        except (DeferredInitializationError, MXNetError):
            self.infer_shape(*args)
            for p in self.collect_params().values():
                if p._deferred_init is not None:
                    p._finish_deferred_init(p.shape)

    def infer_shape(self, *args):
        """Set deferred parameter shapes from the input shapes (layers
        with deferred parameters override this)."""

    def __call__(self, *args):
        from ..cached_op import CachedOp, is_tracing
        from ..symbol.symbol import Symbol
        if (not self._active or is_tracing()
                or (args and isinstance(args[0], Symbol))):
            return super().__call__(*args)
        if self._cached_op is None:
            self._cached_op = CachedOp(self)
        for hook in self._forward_pre_hooks:
            hook(self, args)
        out = self._cached_op(*args)
        for hook in self._forward_hooks:
            hook(self, args, out)
        return out

    def forward(self, *args):
        """``hybrid_forward`` with ``F = sym`` and the parameters as
        variables on Symbols; with ``F = nd`` and the parameters' arrays
        on the input's context on NDArrays."""
        from ..symbol.symbol import Symbol
        x = args[0]
        if isinstance(x, Symbol):
            from .. import symbol as F
            params = {name: F.var(p.name)
                      for name, p in self._reg_params.items()}
            return self.hybrid_forward(F, *args, **params)
        from .. import ndarray as F
        self._ensure_init(args)
        ctx = x.context if isinstance(x, NDArray) else None
        params = {name: p.data(ctx) for name, p in self._reg_params.items()}
        return self.hybrid_forward(F, *args, **params)

    def hybrid_forward(self, F, x, *args, **params):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """``path-symbol.json`` and ``path-NNNN.params`` for deployment
        (reference `block.py:868`): the graph traced with ``F = sym`` and
        the parameters keyed ``arg:``/``aux:`` by the graph's split."""
        from ..serialization import save_ndarrays
        from ..symbol.tracer import trace_block
        sym, arg_dict = trace_block(self)
        with open(f"{path}-symbol.json", "w") as f:
            f.write(sym.tojson())
        aux = set(sym.list_auxiliary_states())
        save_ndarrays(f"{path}-{epoch:04d}.params",
                      {(f"aux:{k}" if k in aux else f"arg:{k}"): v
                       for k, v in arg_dict.items()})

    def optimize_for(self, x, backend=None, **kwargs):
        """Hybridize and run ``x`` (the JAX package's `optimize_for`: the
        captured program is the backend)."""
        self.hybridize(True)
        return self(x)


class SymbolBlock(HybridBlock):
    """A Symbol graph as a Block (reference `block.py:952`).

    ``outputs`` is the graph (a Symbol, or a list of them), ``inputs`` its
    input variables (or their names).  ``params`` maps parameter names to
    values: a `Parameter` (for instance from ``net.collect_params()``) is
    adopted, so training the source net shows here; an NDArray becomes a
    new Parameter on its own context, with no gradient for the graph's
    auxiliary states.  The forward runs the graph's steps
    (`graph_compile.build_steps`, the executor's plan) on the inputs and
    the parameters' arrays, under `autograd.record` as recorded ops.  As
    in the JAX package, it runs in predict mode (BatchNorm on its moving
    statistics, no Dropout) whatever the autograd mode.  ``hybridize()``
    captures it like any other HybridBlock.
    """

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=None)
        from ..symbol.symbol import Group, Symbol
        if isinstance(outputs, (list, tuple)):
            outputs = Group(list(outputs))
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self._symbol_outputs = outputs
        self._input_names = [s.name if isinstance(s, Symbol) else s
                             for s in inputs]
        aux = set(outputs.list_auxiliary_states())
        for name, value in dict((params or {}).items()).items():
            if isinstance(value, Parameter):
                p = value
            else:
                p = Parameter(name, shape=value.shape, dtype=value.dtype,
                              grad_req="null" if name in aux else "write")
                p.initialize(ctx=value.context)
                p.set_data(value)
            self._params._params[name] = p
            self._reg_params[name] = p
        self._plan = None

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """The block of an export: ``path-symbol.json`` and, where given,
        its ``.params`` file, loaded onto ``ctx`` (the card when none is
        given) (reference `block.py:imports`)."""
        from ..context import default_context
        from ..serialization import load_ndarrays
        from ..symbol.symbol import load, var
        sym = load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        params = {}
        if param_file:
            ctx = ctx if ctx is not None else \
                default_context("SymbolBlock.imports")
            for k, v in load_ndarrays(param_file).items():
                params[k.split(":", 1)[1] if ":" in k else k] = \
                    v.as_in_context(ctx)
        return SymbolBlock(sym, [var(n) for n in input_names], params)

    def forward(self, *args):
        from .. import autograd
        from ..graph_compile import build_steps, run_plan
        from ..symbol.symbol import Symbol
        if isinstance(args[0], Symbol):
            raise MXNetError("SymbolBlock: composing it into a Symbol "
                             "graph is not supported; call it on NDArrays")
        if self._plan is None:
            self._plan = build_steps(self._symbol_outputs)
        ctx = args[0].context
        feed = {n: a.data for n, a in zip(self._input_names, args)}
        feed.update({n: p.data(ctx).data
                     for n, p in self._reg_params.items()})
        with autograd.grad_mode():
            outs, _ = run_plan(self._plan, feed)
        res = [NDArray(o) for o in outs]
        return res[0] if len(res) == 1 else res
