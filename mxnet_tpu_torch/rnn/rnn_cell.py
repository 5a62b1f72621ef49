"""Legacy symbolic RNN cells (the counterpart of
`mxnet_tpu/rnn/rnn_cell.py`; reference `python/mxnet/rnn/rnn_cell.py`):
cells compose `Symbol` graphs that `Predictor` serves and `Module` trains,
the pre-Gluon recurrent workflow of the reference's `example/rnn/`.

Ported: `RNNParams`, `BaseRNNCell` (``begin_state``, the batch-shaped
symbolic zero states, ``unroll``), `LSTMCell` and `SequentialRNNCell`,
which build the same graph, node for node and name for name, as the JAX
package's.  As there, ``unroll(begin_state=None)`` derives the zero states
from the first input (``slice_axis(x, -1, 0, 1) * 0`` broadcast to the
state width) rather than ``sym.zeros((0, H))``: shape inference has no
"0 = unknown dim" convention.

`LSTMCell` emits the unfused cell (``SliceChannel(gates, 4)``, σ/σ/tanh/σ,
``f·c + i·g``, ``o·tanh(c')``), which `graph_opt`'s ``pallas_select``
rewrites onto the fused cell-update kernel at inference.
"""
from __future__ import annotations

from typing import Dict, List

from .. import symbol as sym_mod
from ..base import MXNetError
from ..symbol.symbol import Symbol, var

__all__ = ["RNNParams", "BaseRNNCell", "LSTMCell", "SequentialRNNCell"]


class RNNParams:
    """Container for cell weights: `get` creates (or reuses) a prefixed
    symbol variable, so the steps of an unrolled cell share them."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params: Dict[str, Symbol] = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = var(name, **kwargs)
        return self._params[name]


def _normalize_sequence(length, inputs, layout, merge):
    """Split or merge ``inputs`` to the requested form.  Returns
    ``(list_or_symbol, axis)``."""
    if layout not in ("NTC", "TNC"):
        raise MXNetError("layout must be NTC or TNC")
    axis = layout.find("T")
    if isinstance(inputs, Symbol):
        if merge is False:
            outs = list(sym_mod.split(inputs, num_outputs=length,
                                      axis=axis, squeeze_axis=True))
            return outs, axis
        return inputs, axis
    # list of per-step symbols
    if merge is True:
        expanded = [sym_mod.expand_dims(x, axis=axis) for x in inputs]
        return sym_mod.concat(*expanded, dim=axis), axis
    return list(inputs), axis


class BaseRNNCell:
    """Abstract cell (reference `rnn_cell.py:BaseRNNCell`)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def prefix(self):
        return self._prefix

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def __call__(self, inputs, states):
        raise NotImplementedError

    # -- states ------------------------------------------------------------
    def begin_state(self, func=None, **kwargs):
        """Initial-state symbols: named variables by default (a bind
        supplies them); pass ``func`` (a symbol constructor taking ``name``
        and ``shape``) and ``batch_size=`` for concrete shapes."""
        if self._modified:
            raise MXNetError("modifier cells construct begin_state from "
                             "their base cell")
        batch = kwargs.pop("batch_size", 0)
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = f"{self._prefix}begin_state_{self._init_counter}"
            if func is None:
                states.append(var(name))
            else:
                shape = info.get("shape")
                if shape and 0 in shape:
                    # the zero is the unknown batch dim
                    if not batch:
                        raise MXNetError("pass batch_size for concrete "
                                         "begin_state shapes")
                    shape = tuple(batch if d == 0 else d for d in shape)
                states.append(func(name=name, shape=shape, **kwargs))
        return states

    def _zeros_like_state(self, sample: Symbol):
        """Batch-shaped symbolic zeros per state, derived from a per-step
        input symbol (N, C)."""
        zeros_col = sym_mod.slice_axis(sample, axis=-1, begin=0,
                                       end=1) * 0.0
        return [sym_mod.broadcast_axis(zeros_col, axis=1,
                                       size=info["shape"][-1])
                for info in self.state_info]

    # -- weights -----------------------------------------------------------
    def unpack_weights(self, args):
        return dict(args)

    def pack_weights(self, args):
        return dict(args)

    # -- unroll ------------------------------------------------------------
    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll for ``length`` steps (reference `BaseRNNCell.unroll`):
        ``(outputs, states)``, the outputs one symbol per step, or one
        merged along T with ``merge_outputs``."""
        self.reset()
        steps, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self._zeros_like_state(steps[0])
        states = begin_state
        outputs = []
        for i in range(length):
            out, states = self(steps[i], states)
            outputs.append(out)
        if merge_outputs:
            outputs, _ = _normalize_sequence(length, outputs, layout, True)
        return outputs, states


class LSTMCell(BaseRNNCell):
    """LSTM, gate order [i, f, g, o] (reference `rnn_cell.py:LSTMCell`).
    ``forget_bias`` is kept for the reference's signature; as in the JAX
    package it adds nothing to the graph (the reference applies it through
    the bias initializer)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = sym_mod.FullyConnected(inputs, weight=self._iW,
                                     bias=self._iB,
                                     num_hidden=4 * self._num_hidden,
                                     name=f"{name}i2h")
        h2h = sym_mod.FullyConnected(states[0], weight=self._hW,
                                     bias=self._hB,
                                     num_hidden=4 * self._num_hidden,
                                     name=f"{name}h2h")
        gates = i2h + h2h
        g = sym_mod.SliceChannel(gates, num_outputs=4,
                                 name=f"{name}slice")
        in_gate = sym_mod.Activation(g[0], act_type="sigmoid")
        forget_gate = sym_mod.Activation(g[1], act_type="sigmoid")
        in_transform = sym_mod.Activation(g[2], act_type="tanh")
        out_gate = sym_mod.Activation(g[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * sym_mod.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class SequentialRNNCell(BaseRNNCell):
    """Stacked cells: the output of one feeds the next (reference
    `rnn_cell.py:SequentialRNNCell`)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells: List[BaseRNNCell] = []

    def add(self, cell):
        self._cells.append(cell)
        return self

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, func=None, **kwargs):
        return [s for c in self._cells
                for s in c.begin_state(func=func, **kwargs)]

    def unpack_weights(self, args):
        for c in self._cells:
            args = c.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for c in self._cells:
            args = c.pack_weights(args)
        return args

    def _split_states(self, states):
        out = []
        pos = 0
        for c in self._cells:
            n = len(c.state_info)
            out.append(states[pos:pos + n])
            pos += n
        return out

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        for c, s in zip(self._cells, self._split_states(states)):
            inputs, ns = c(inputs, s)
            next_states.extend(ns)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll each cell over the whole sequence in turn; only the last
        one merges its outputs."""
        self.reset()
        num_cells = len(self._cells)
        if begin_state is not None:
            split = self._split_states(begin_state)
        next_states = []
        for i, cell in enumerate(self._cells):
            merge = merge_outputs if i == num_cells - 1 else None
            inputs, states = cell.unroll(
                length, inputs,
                begin_state=None if begin_state is None else split[i],
                layout=layout, merge_outputs=merge)
            next_states.extend(states)
        return inputs, next_states
