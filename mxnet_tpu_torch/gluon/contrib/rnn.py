"""gluon.contrib.rnn (the counterpart of `mxnet_tpu/gluon/contrib/rnn.py`;
reference `python/mxnet/gluon/contrib/rnn/`): VariationalDropoutCell,
LSTMPCell (projected LSTM), and the 1/2/3-D convolutional RNN/LSTM/GRU
cells.

Each cell is a `HybridRecurrentCell`: hybridized, a step is one
`CachedOp` call (a CUDA graph replay on the card).  VariationalDropoutCell
draws each mask once per sequence (cleared by ``reset``, which ``unroll``
calls) from the generator of the device its input lives on.  LSTMPCell's
gates are split with ``split``, which the graph optimizer's LSTM matcher
does not take (it matches ``SliceChannel``, in both packages), so its
steps never reach the fused LSTM cell kernel.
"""
from __future__ import annotations

from ..rnn.rnn_cell import HybridRecurrentCell, _ModifierCell

__all__ = ["VariationalDropoutCell", "LSTMPCell",
           "Conv1DRNNCell", "Conv1DLSTMCell", "Conv1DGRUCell",
           "Conv2DRNNCell", "Conv2DLSTMCell", "Conv2DGRUCell",
           "Conv3DRNNCell", "Conv3DLSTMCell", "Conv3DGRUCell"]


class VariationalDropoutCell(_ModifierCell):
    """Same dropout mask across time steps (reference
    `contrib/rnn/rnn_cell.py:VariationalDropoutCell`)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._mask_inputs = None
        self._mask_states = None
        self._mask_outputs = None

    def reset(self):
        super().reset()
        self._mask_inputs = None
        self._mask_states = None
        self._mask_outputs = None

    def _mask(self, F, name, p, like):
        """Mask = Dropout(ones_like(x)) so the same spelling works for
        NDArray and Symbol; cached per unroll (cleared by reset()) —
        that is the 'variational' part."""
        mask = getattr(self, name)
        if mask is None and p > 0:
            from ... import autograd
            if autograd.is_training():
                mask = F.Dropout(F.ones_like(like), p=p)
                setattr(self, name, mask)
        return getattr(self, name)

    def hybrid_forward(self, F, inputs, states):
        if self.drop_inputs:
            m = self._mask(F, "_mask_inputs", self.drop_inputs, inputs)
            if m is not None:
                inputs = inputs * m
        if self.drop_states:
            m = self._mask(F, "_mask_states", self.drop_states, states[0])
            if m is not None:
                states = [states[0] * m] + list(states[1:])
        out, states = self.base_cell(inputs, states)
        if self.drop_outputs:
            m = self._mask(F, "_mask_outputs", self.drop_outputs, out)
            if m is not None:
                out = out * m
        return out, states


class _ConvRNNCellBase(HybridRecurrentCell):
    """Convolutional recurrence: gates come from conv(input) + conv(state)
    (reference `contrib/rnn/conv_rnn_cell.py`, 1/2/3 spatial dims)."""

    _dims = 2

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 n_gates, activation="tanh", prefix=None, params=None):
        super().__init__(prefix, params)
        d = self._dims
        self._hidden_channels = hidden_channels
        self._input_shape = tuple(input_shape)   # (C, *spatial)
        self._i2h_kernel = (tuple(i2h_kernel)
                            if isinstance(i2h_kernel, (tuple, list))
                            else (i2h_kernel,) * d)
        self._h2h_kernel = (tuple(h2h_kernel)
                            if isinstance(h2h_kernel, (tuple, list))
                            else (h2h_kernel,) * d)
        self._n_gates = n_gates
        self._activation = activation
        if len(self._i2h_kernel) != d or len(self._h2h_kernel) != d:
            raise ValueError(
                f"{type(self).__name__} expects {d}-D kernels; got "
                f"{self._i2h_kernel}/{self._h2h_kernel}")
        if len(self._input_shape) != d + 1:
            raise ValueError(
                f"{type(self).__name__} expects input_shape of "
                f"(channels, *{d} spatial dims); got {self._input_shape}")
        for k in self._i2h_kernel + self._h2h_kernel:
            if k % 2 == 0:
                raise ValueError(
                    "Conv RNN cells require odd kernel sizes (same-padding "
                    f"state recurrence); got {self._i2h_kernel}/"
                    f"{self._h2h_kernel}")
        in_c = self._input_shape[0]
        self.i2h_weight = self.params.get(
            "i2h_weight",
            shape=(n_gates * hidden_channels, in_c) + self._i2h_kernel)
        self.h2h_weight = self.params.get(
            "h2h_weight",
            shape=(n_gates * hidden_channels,
                   hidden_channels) + self._h2h_kernel)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(n_gates * hidden_channels,), init="zeros")
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(n_gates * hidden_channels,), init="zeros")

    def state_info(self, batch_size=0):
        spatial = self._input_shape[1:]
        shape = (batch_size, self._hidden_channels) + spatial
        layout = {1: "NCW", 2: "NCHW", 3: "NCDHW"}[self._dims]
        return [{"shape": shape, "__layout__": layout}] * self._n_states

    def _conv_gates(self, F, inputs, state, i2h_weight, h2h_weight,
                    i2h_bias, h2h_bias):
        pad_i = tuple(k // 2 for k in self._i2h_kernel)
        pad_h = tuple(k // 2 for k in self._h2h_kernel)
        ng = self._n_gates * self._hidden_channels
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias, kernel=self._i2h_kernel,
                            num_filter=ng, pad=pad_i)
        h2h = F.Convolution(state, h2h_weight, h2h_bias, kernel=self._h2h_kernel,
                            num_filter=ng, pad=pad_h)
        return i2h + h2h


class _ConvRNNForward:
    """Plain conv recurrence: out = act(gates)."""

    _n_states = 1
    _n_gates = 1

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        g = self._conv_gates(F, inputs, states[0], i2h_weight, h2h_weight,
                             i2h_bias, h2h_bias)
        out = F.Activation(g, act_type=self._activation)
        return out, [out]


class _ConvLSTMForward:
    """Conv LSTM recurrence, gate order [i, f, g, o]."""

    _n_states = 2
    _n_gates = 4

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        g = self._conv_gates(F, inputs, states[0], i2h_weight, h2h_weight,
                             i2h_bias, h2h_bias)
        hc = self._hidden_channels
        i = F.sigmoid(F.slice_axis(g, axis=1, begin=0, end=hc))
        f = F.sigmoid(F.slice_axis(g, axis=1, begin=hc, end=2 * hc))
        c_in = F.Activation(F.slice_axis(g, axis=1, begin=2 * hc, end=3 * hc),
                            act_type=self._activation)
        o = F.sigmoid(F.slice_axis(g, axis=1, begin=3 * hc, end=4 * hc))
        c = f * states[1] + i * c_in
        h = o * F.Activation(c, act_type=self._activation)
        return h, [h, c]


class _ConvGRUForward:
    """Conv GRU recurrence: reset gates the STATE conv contribution."""

    _n_states = 1
    _n_gates = 3

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        hc = self._hidden_channels
        pad_i = tuple(k // 2 for k in self._i2h_kernel)
        pad_h = tuple(k // 2 for k in self._h2h_kernel)
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, num_filter=3 * hc,
                            pad=pad_i)
        h2h = F.Convolution(states[0], h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, num_filter=3 * hc,
                            pad=pad_h)
        i_r = F.slice_axis(i2h, axis=1, begin=0, end=hc)
        i_z = F.slice_axis(i2h, axis=1, begin=hc, end=2 * hc)
        i_h = F.slice_axis(i2h, axis=1, begin=2 * hc, end=3 * hc)
        h_r = F.slice_axis(h2h, axis=1, begin=0, end=hc)
        h_z = F.slice_axis(h2h, axis=1, begin=hc, end=2 * hc)
        h_h = F.slice_axis(h2h, axis=1, begin=2 * hc, end=3 * hc)
        r = F.sigmoid(i_r + h_r)
        z = F.sigmoid(i_z + h_z)
        h_cand = F.Activation(i_h + r * h_h, act_type=self._activation)
        out = (1 - z) * h_cand + z * states[0]
        return out, [out]


def _make_conv_cell(forward_mixin, dims, default_kernel):
    class Cell(forward_mixin, _ConvRNNCellBase):
        _dims = dims

        def __init__(self, input_shape, hidden_channels,
                     i2h_kernel=default_kernel, h2h_kernel=default_kernel,
                     activation="tanh", **kwargs):
            super().__init__(input_shape, hidden_channels, i2h_kernel,
                             h2h_kernel, n_gates=self._n_gates,
                             activation=activation, **kwargs)

    return Cell


# nine SIBLING leaf classes (reference conv_rnn_cell.py registers all
# nine; siblings, not subclasses, so isinstance(cell, Conv2DLSTMCell)
# is never true of a 1-D or 3-D cell)
Conv1DRNNCell = _make_conv_cell(_ConvRNNForward, 1, (3,))
Conv1DLSTMCell = _make_conv_cell(_ConvLSTMForward, 1, (3,))
Conv1DGRUCell = _make_conv_cell(_ConvGRUForward, 1, (3,))
Conv2DRNNCell = _make_conv_cell(_ConvRNNForward, 2, (3, 3))
Conv2DLSTMCell = _make_conv_cell(_ConvLSTMForward, 2, (3, 3))
Conv2DGRUCell = _make_conv_cell(_ConvGRUForward, 2, (3, 3))
Conv3DRNNCell = _make_conv_cell(_ConvRNNForward, 3, (3, 3, 3))
Conv3DLSTMCell = _make_conv_cell(_ConvLSTMForward, 3, (3, 3, 3))
Conv3DGRUCell = _make_conv_cell(_ConvGRUForward, 3, (3, 3, 3))
for _n, _c in list(globals().items()):
    if _n.startswith("Conv") and _n.endswith("Cell"):
        _c.__name__ = _n
        _c.__qualname__ = _n


class LSTMPCell(HybridRecurrentCell):
    """Projected LSTM (reference `contrib/rnn/rnn_cell.py:LSTMPCell`,
    https://arxiv.org/abs/1402.1128): a standard LSTM whose recurrent
    state is the PROJECTION r_t = W_hr h_t, shrinking the recurrent
    matmul from hidden² to hidden×projection — states are
    [r (projection_size), c (hidden_size)]."""

    def __init__(self, hidden_size, projection_size, prefix=None,
                 params=None, input_size=0):
        super().__init__(prefix, params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size))
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size))
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,), init="zeros")
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,), init="zeros")

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_shape(self, *args):
        x = args[0]
        if self.i2h_weight.shape and self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])
            self._input_size = x.shape[-1]

    def _alias(self):
        return "lstmp"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        h = self._hidden_size
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * h)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * h)
        gates = i2h + h2h
        in_gate, forget_gate, in_transform, out_gate = F.split(
            gates, num_outputs=4, axis=-1)
        next_c = (F.sigmoid(forget_gate) * states[1]
                  + F.sigmoid(in_gate) * F.tanh(in_transform))
        next_h = F.sigmoid(out_gate) * F.tanh(next_c)
        next_r = F.FullyConnected(next_h, h2r_weight, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]
