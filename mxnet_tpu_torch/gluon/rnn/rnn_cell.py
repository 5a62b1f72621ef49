"""Gluon recurrent cells (the counterpart of
`mxnet_tpu/gluon/rnn/rnn_cell.py`; reference
`python/mxnet/gluon/rnn/rnn_cell.py`).

A cell is one step of a recurrence, a Block called as ``cell(x,
states) -> (output, new_states)``; ``unroll`` steps it over a sequence
from Python, imperatively, as the JAX package's does.  With
``valid_length`` the outputs past each sample's length are zero
(`SequenceMask`) and each sample's returned state is its state at its
own length (`SequenceLast` over the stacked per-step states), the
reference's contract.  States are made on the input's device.  The
fused whole-sequence layers are `rnn_layer`.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import Block, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout):
    """The per-step (N, C) arrays of ``inputs`` (a list of steps, or one
    array with a T axis where ``layout`` puts it): ``(steps, axis)``."""
    axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        return list(inputs), axis
    if length is not None and inputs.shape[axis] != length:
        raise MXNetError(
            f"sequence length {inputs.shape[axis]} != expected {length}")
    return _unstack(inputs, inputs.shape[axis], axis), axis


def _unstack(x, length, axis):
    """``x`` split along ``axis`` into ``length`` arrays without it."""
    from ... import ndarray as F
    if length == 1:
        return [F.squeeze(x, axis=axis)]
    return [F.squeeze(s, axis=axis) for s in
            F.split(x, num_outputs=length, axis=axis, squeeze_axis=False)]


class RecurrentCell(Block):
    """Abstract cell (reference `rnn_cell.py:RecurrentCell`)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset the step counters before a new sequence."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states: zeros (``kwargs`` go to `nd.zeros`, ``ctx``
        among them), or ``func(name=..., shape=..., **kwargs)``."""
        if self._modified:
            raise MXNetError("After applying modifier cells the base cell "
                             "cannot be called directly. Call the modifier "
                             "cell instead.")
        from ... import ndarray as nd
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if func is None:
                states.append(nd.zeros(info["shape"], **kwargs))
            else:
                states.append(func(name=f"{self._prefix}begin_state_"
                              f"{self._init_counter}", **info, **kwargs))
        return states

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """The cell stepped over ``length`` steps (reference
        `rnn_cell.py:unroll`): ``(outputs, states)``, the outputs merged
        along T with ``merge_outputs`` (always with ``valid_length``
        when merging)."""
        from ... import ndarray as F
        self.reset()
        seq, axis = _format_sequence(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=seq[0].shape[0],
                                           ctx=seq[0].context)
        states = begin_state
        outputs, all_states = [], []
        for i in range(length):
            output, states = self(seq[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [F.SequenceLast(F.stack(*ele, axis=0), valid_length,
                                     use_sequence_length=True, axis=0)
                      for ele in zip(*all_states)]
            masked = F.SequenceMask(F.stack(*outputs, axis=axis),
                                    valid_length, use_sequence_length=True,
                                    axis=axis)
            if merge_outputs:
                return masked, states
            return _unstack(masked, length, axis), states
        if merge_outputs:
            return F.stack(*outputs, axis=axis), states
        return outputs, states

    def forward(self, inputs, states):
        raise NotImplementedError


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """A cell whose step is a ``hybrid_forward(F, x, states, **params)``
    (reference `rnn_cell.py:HybridRecurrentCell`); hybridized, a step is
    one `CachedOp` call (a CUDA graph replay on the card)."""

    def forward(self, inputs, states):
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, states, **params):
        raise NotImplementedError


class _BaseRNNCell(HybridRecurrentCell):
    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        g = self._gates
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(g * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(g * hidden_size, hidden_size),
            init=h2h_weight_initializer)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(g * hidden_size,), init=i2h_bias_initializer)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(g * hidden_size,), init=h2h_bias_initializer)

    def infer_shape(self, x, *args):
        if self.i2h_weight.shape and self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (self._gates * self._hidden_size,
                                     x.shape[-1])
            self._input_size = x.shape[-1]

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]


class RNNCell(_BaseRNNCell):
    """Elman cell, h' = act(W_i x + b_i + W_h h + b_h) (reference
    `rnn_cell.py:RNNCell`)."""

    _gates = 1

    def __init__(self, hidden_size, activation="tanh", **kwargs):
        super().__init__(hidden_size, **kwargs)
        self._activation = activation

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_BaseRNNCell):
    """LSTM cell, gate order [i, f, g, o] (reference
    `rnn_cell.py:LSTMCell`)."""

    _gates = 4

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h = self._hidden_size
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * h)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * h)
        in_gate, forget_gate, in_transform, out_gate = F.split(
            i2h + h2h, num_outputs=4, axis=-1)
        next_c = F.sigmoid(forget_gate) * states[1] + \
            F.sigmoid(in_gate) * F.tanh(in_transform)
        next_h = F.sigmoid(out_gate) * F.tanh(next_c)
        return next_h, [next_h, next_c]

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]


class GRUCell(_BaseRNNCell):
    """GRU cell, gate order [r, z, n] (reference `rnn_cell.py:GRUCell`)."""

    _gates = 3

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h = self._hidden_size
        prev_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * h)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=3 * h)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=-1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=-1)
        reset_gate = F.sigmoid(i2h_r + h2h_r)
        update_gate = F.sigmoid(i2h_z + h2h_z)
        next_h_tmp = F.tanh(i2h_n + reset_gate * h2h_n)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells applied in turn at each step (reference
    `rnn_cell.py:SequentialRNNCell`)."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        if self._modified:
            raise MXNetError("call the modifier cell, not its base cell")
        return _cells_begin_state(self._children.values(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        pos = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[pos:pos + n])
            pos += n
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._children)


class _ModifierCell(HybridRecurrentCell):
    """A cell around a base cell whose parameters it uses."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        if self._modified:
            raise MXNetError("call the modifier cell, not its base cell")
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class DropoutCell(HybridRecurrentCell):
    """Dropout on each step's input (reference `rnn_cell.py:DropoutCell`)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate,
                               axes=self._axes if self._axes else None)
        return inputs, states


class ZoneoutCell(_ModifierCell):
    """Zoneout (reference `rnn_cell.py:ZoneoutCell`): where a Dropout mask
    of ones is 0, the output and each state keep their previous
    values."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        if isinstance(base_cell, BidirectionalCell):
            raise MXNetError("BidirectionalCell doesn't support zoneout")
        super().__init__(base_cell)
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def forward(self, inputs, states):
        from ... import ndarray as F
        next_output, next_states = self.base_cell(inputs, states)
        po, ps = self._zoneout_outputs, self._zoneout_states

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = (F.where(mask(po, next_output), next_output, prev_output)
                  if po != 0.0 else next_output)
        new_states = ([F.where(mask(ps, new_s), new_s, old_s)
                       for new_s, old_s in zip(next_states, states)]
                      if ps != 0.0 else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(_ModifierCell):
    """The base cell's output plus its input (reference
    `rnn_cell.py:ResidualCell`)."""

    def forward(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Two cells over the sequence in opposite directions, their outputs
    concatenated; it only unrolls (reference
    `rnn_cell.py:BidirectionalCell`).  With ``valid_length`` the backward
    cell sees each sample's own steps reversed (`SequenceReverse`)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__()
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cell cannot be stepped. Please use "
                         "unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        if self._modified:
            raise MXNetError("call the modifier cell, not its base cell")
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as F
        self.reset()
        seq, axis = _format_sequence(length, inputs, layout)
        batch_size = seq[0].shape[0]
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size,
                                           ctx=seq[0].context)
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info(batch_size))

        def seq_reverse(steps):
            if valid_length is None:
                return list(reversed(steps))
            rev = F.SequenceReverse(F.stack(*steps, axis=0), valid_length,
                                    use_sequence_length=True)
            return _unstack(rev, length, 0)

        l_outputs, l_states = l_cell.unroll(
            length, seq, begin_state[:n_l], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, seq_reverse(seq), begin_state[n_l:], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        r_outputs = seq_reverse(r_outputs)
        outputs = [F.concat_nd([l_o, r_o], axis=1)
                   for l_o, r_o in zip(l_outputs, r_outputs)]
        if merge_outputs or valid_length is not None:
            outputs = F.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
