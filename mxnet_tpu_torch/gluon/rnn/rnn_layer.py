"""Gluon's fused recurrent layers (the counterpart of
`mxnet_tpu/gluon/rnn/rnn_layer.py`; reference
`python/mxnet/gluon/rnn/rnn_layer.py`): `RNN`, `LSTM` and `GRU` over the
``RNN`` op (`ops/rnn_op.py`, cuDNN's RNN on the card).

Each (layer, direction) holds ``{l,r}<i>_{i2h,h2h}_{weight,bias}``, the
JAX package's names, so a `.params` file loads in either package; a
forward packs them, weights then biases, into the op's flat vector with
``F.concat_nd``.  Called without states the layer starts from zeros on
the input's device and returns the output alone; with states it returns
``(output, new_states)``.  ``dropout`` applies between layers in
training.  Hybridized, a call is one `CachedOp` call (on the card a CUDA
graph replay, and under ``autograd.record`` in train mode a captured
forward and backward).
"""
from __future__ import annotations

from ...ops.rnn_op import _GATES
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, prefix=None, params=None):
        super().__init__(prefix, params)
        if layout not in ("TNC", "NTC"):
            raise ValueError(f"Invalid layout {layout}; must be one of "
                             "['TNC' or 'NTC']")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = _GATES[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param(f"{j}{i}_i2h_weight", (ng * nh, ni),
                                     i2h_weight_initializer)
                self._register_param(f"{j}{i}_h2h_weight", (ng * nh, nh),
                                     h2h_weight_initializer)
                self._register_param(f"{j}{i}_i2h_bias", (ng * nh,),
                                     i2h_bias_initializer)
                self._register_param(f"{j}{i}_h2h_bias", (ng * nh,),
                                     h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        self._reg_params[name] = self.params.get(
            name, shape=shape, init=init, allow_deferred_init=True)

    def infer_shape(self, x, *args):
        ni = x.shape[-1]
        ng, nh = self._gates, self._hidden_size
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                p = self._reg_params[f"{j}{i}_i2h_weight"]
                if p.shape is None or 0 in p.shape:
                    p.shape = (ng * nh, ni)
            ni = nh * self._dir
        self._input_size = x.shape[-1]

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states (``kwargs`` go to `nd.zeros`, ``ctx`` among them),
        or ``func(name=..., shape=..., **kwargs)``."""
        from ... import ndarray as nd
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if func is None:
                states.append(nd.zeros(info["shape"], **kwargs))
            else:
                info.update(kwargs)
                states.append(func(name=f"{self.prefix}h0_{i}", **info))
        return states

    def hybrid_forward(self, F, inputs, states=None, **params):
        skip_states = states is None
        if skip_states:
            states = self.begin_state(inputs.shape[self._layout.find("N")],
                                      ctx=inputs.context,
                                      dtype=inputs.dtype)
        if not isinstance(states, (list, tuple)):
            states = [states]
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        dirs = ["l", "r"][:self._dir]
        flat = [F.reshape(params[f"{j}{i}_{kind}"], shape=(-1,))
                for group in ("weight", "bias")
                for i in range(self._num_layers) for j in dirs
                for kind in (f"i2h_{group}", f"h2h_{group}")]
        flat_params = F.concat_nd(flat, axis=0) if len(flat) > 1 \
            else flat[0]
        out = F.RNN(inputs, flat_params, *states,
                    state_size=self._hidden_size,
                    num_layers=self._num_layers,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=True, mode=self._mode)
        outputs, recurrent_states = out[0], out[1:]
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        if skip_states:
            return outputs
        return outputs, list(recurrent_states)

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        mapping = f"{self._input_size or None} -> {self._hidden_size}"
        return s.format(name=type(self).__name__, mapping=mapping,
                        **self.__dict__)


class RNN(_RNNLayer):
    """Multi-layer Elman RNN (reference `rnn_layer.py:RNN`)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference `rnn_layer.py:LSTM`)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size,
                 self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU (reference `rnn_layer.py:GRU`)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
