"""The fused ``RNN`` op (the counterpart of `mxnet_tpu/ops/rnn_op.py`;
reference `src/operator/rnn-inl.h`, GPU path `src/operator/cudnn_rnn-inl.h`).

Multi-layer, optionally bidirectional vanilla (``rnn_tanh``,
``rnn_relu``), LSTM and GRU over (T, N, C) data, the weights in one packed
vector with the reference's layout: all weights first, per layer and
direction the i2h (G·H, in) then the h2h (G·H, H) matrix, then all biases
in the same order (i2h, h2h).  Gate order: LSTM [i, f, g, o], GRU
[r, z, n], the cuDNN convention.

The JAX op runs the recurrence under ``lax.scan`` and reaches no Pallas
kernel.  Here the op runs PyTorch's RNN (`torch._VF.lstm`, ``gru``,
``rnn_tanh``, ``rnn_relu``): cuDNN's fused RNN on the card, as the
reference MXNet's GPU path, and PyTorch's native RNN on the CPU.  Each
(layer, direction) hands it views of the packed vector (`unpack_params`);
cuDNN copies them into its own flat layout, which interleaves each
layer's weights and biases, at every call.  Dropout between layers (``p``,
training only) runs the layers one call each and draws its masks from the
op's generator as the port's `Dropout` does, never from cuDNN's own
dropout state, so a captured replay draws new masks as the registered
generator advances.

`rnn_forward_plain` is the JAX op's step loop written out (`cell_step`
per step, `layer_loop` per layer and direction), kept as the oracle the
tests and ``chip_smoke.py`` hold the op against; its masks are drawn in
the same order, so with the generator reseeded both draw the same ones.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .registry import register

__all__ = ["cell_step", "layer_loop", "rnn_forward", "rnn_forward_plain",
           "unpack_params", "param_size"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}

LayerParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def cell_step(mode, xp_t, h, c, h2h_w, h2h_b):
    """One recurrence step given the step's input projection ``xp_t``:
    ``(new_h, new_c)`` (``new_c`` None but for LSTM)."""
    if mode == "lstm":
        gates = xp_t + h @ h2h_w.t() + h2h_b
        i, f, g, o = gates.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(new_c), new_c
    if mode == "gru":
        xr, xz, xn = xp_t.chunk(3, dim=-1)
        hr, hz, hn = (h @ h2h_w.t() + h2h_b).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h, None
    act = torch.tanh if mode == "rnn_tanh" else torch.relu
    return act(xp_t + h @ h2h_w.t() + h2h_b), None


def layer_loop(mode, x, h0, c0, i2h_w, i2h_b, h2h_w, h2h_b, reverse=False):
    """One direction of one layer, step by step: ``(outputs (T, N, H),
    h_T, c_T)``.  The input projection of the whole sequence is one
    product, as in the JAX op."""
    xp = x @ i2h_w.t() + i2h_b
    h, c = h0, (c0 if c0 is not None or mode != "lstm"
                else torch.zeros_like(h0))
    steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    outs: List[Optional[torch.Tensor]] = [None] * x.shape[0]
    for t in steps:
        h, c = cell_step(mode, xp[t], h, c, h2h_w, h2h_b)
        outs[t] = h
    return torch.stack(outs), h, c


def _dropout(out, p, generator):
    """The port's `Dropout` in training: keep with 1 - p, scale by
    1/(1 - p)."""
    keep = torch.empty(out.shape, device=out.device).bernoulli_(
        1.0 - p, generator=generator)
    return torch.where(keep.bool(), out / (1.0 - p),
                       torch.zeros((), dtype=out.dtype, device=out.device))


def rnn_forward_plain(mode, x, states, layer_params: Sequence[LayerParams],
                      bidirectional=False, dropout=0.0, generator=None):
    """The stacked (bi)RNN by the step loop.  ``layer_params``: per
    (layer, direction) in the packed order, ``(i2h_w, i2h_b, h2h_w,
    h2h_b)``; ``states``: ``(h0 (L·D, N, H), c0 or None)``.  Returns
    ``(out (T, N, D·H), h_T (L·D, N, H), c_T or None)``."""
    num_dir = 2 if bidirectional else 1
    num_layers = len(layer_params) // num_dir
    h0, c0 = states
    hs, cs = [], []
    out = x
    for layer in range(num_layers):
        dir_outs = []
        for d in range(num_dir):
            idx = layer * num_dir + d
            o, h_t, c_t = layer_loop(
                mode, out, h0[idx], c0[idx] if c0 is not None else None,
                *layer_params[idx], reverse=(d == 1))
            dir_outs.append(o)
            hs.append(h_t)
            if c_t is not None:
                cs.append(c_t)
        out = dir_outs[0] if num_dir == 1 else torch.cat(dir_outs, -1)
        if dropout > 0.0 and layer < num_layers - 1:
            out = _dropout(out, dropout, generator)
    return out, torch.stack(hs), torch.stack(cs) if cs else None


def _vf_call(mode, x, h0, c0, flat_params, num_layers, bidirectional,
             train):
    """One `torch._VF` RNN call over ``num_layers`` layers (no dropout
    inside it): ``(out, h_T, c_T or None)``."""
    fn = getattr(torch._VF, mode)
    hx = (h0, c0) if mode == "lstm" else h0
    res = fn(x, hx, flat_params, True, num_layers, 0.0, train,
             bidirectional, False)
    return (res[0], res[1], res[2]) if mode == "lstm" else \
        (res[0], res[1], None)


def rnn_forward(mode, x, states, layer_params: Sequence[LayerParams],
                bidirectional=False, dropout=0.0, generator=None,
                train=False):
    """The stacked (bi)RNN through PyTorch's RNN (cuDNN on the card);
    arguments and result as `rnn_forward_plain`.  ``train`` asks the
    library to keep what its backward reads."""
    num_dir = 2 if bidirectional else 1
    num_layers = len(layer_params) // num_dir
    h0, c0 = states
    if mode == "lstm" and c0 is None:
        c0 = torch.zeros_like(h0)
    # torch orders each (layer, direction) as w_ih, w_hh, b_ih, b_hh
    flat = [t for i2h_w, i2h_b, h2h_w, h2h_b in layer_params
            for t in (i2h_w, h2h_w, i2h_b, h2h_b)]
    x = x.contiguous()
    if dropout == 0.0 or num_layers == 1:
        return _vf_call(mode, x, h0.contiguous(),
                        None if c0 is None else c0.contiguous(), flat,
                        num_layers, bidirectional, train)
    hs, cs = [], []
    per = 4 * num_dir
    out = x
    for layer in range(num_layers):
        sl = slice(layer * num_dir, (layer + 1) * num_dir)
        out, h_t, c_t = _vf_call(
            mode, out, h0[sl].contiguous(),
            None if c0 is None else c0[sl].contiguous(),
            flat[layer * per:(layer + 1) * per], 1, bidirectional, train)
        hs.append(h_t)
        if c_t is not None:
            cs.append(c_t)
        if layer < num_layers - 1:
            out = _dropout(out, dropout, generator).contiguous()
    return out, torch.cat(hs), torch.cat(cs) if cs else None


def unpack_params(flat, mode, num_layers, input_size, hidden, num_dir
                  ) -> List[LayerParams]:
    """Views of the packed vector, per (layer, direction):
    ``(i2h_w, i2h_b, h2h_w, h2h_b)``."""
    g = _GATES[mode]
    pos = 0
    weights = []
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else hidden * num_dir
        for _ in range(num_dir):
            n = g * hidden * in_size
            i2h_w = flat[pos:pos + n].view(g * hidden, in_size)
            pos += n
            n = g * hidden * hidden
            h2h_w = flat[pos:pos + n].view(g * hidden, hidden)
            pos += n
            weights.append((i2h_w, h2h_w))
    params = []
    for i2h_w, h2h_w in weights:
        gh = i2h_w.shape[0]
        i2h_b = flat[pos:pos + gh]
        h2h_b = flat[pos + gh:pos + 2 * gh]
        pos += 2 * gh
        params.append((i2h_w, i2h_b, h2h_w, h2h_b))
    return params


def param_size(mode, num_layers, input_size, hidden, num_dir) -> int:
    """Length of the packed vector."""
    g = _GATES[mode]
    total = 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else hidden * num_dir
        total += num_dir * (g * hidden * (in_size + hidden) + 2 * g * hidden)
    return total


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


@register("RNN", num_inputs=None,
          input_names=["data", "parameters", "state", "state_cell"],
          needs_rng=True, uses_train_mode=True,
          num_outputs=lambda attrs: (
              (3 if attrs.get_str("mode") == "lstm" else 2)
              if attrs.get_bool("state_outputs", False) else 1))
def _rnn(attrs, generator, data, parameters, state, state_cell=None):
    """Reference ``RNN`` (`src/operator/rnn-inl.h`): fused multi-layer,
    optionally bidirectional vanilla/LSTM/GRU over TNC data; dropout ``p``
    between layers in training only."""
    mode = attrs.get_str("mode", "lstm")
    hidden = attrs.get_int("state_size")
    num_layers = attrs.get_int("num_layers", 1)
    bidirectional = attrs.get_bool("bidirectional", False)
    train = attrs.get_bool("__train", False)
    p = attrs.get_float("p", 0.0) if train else 0.0
    num_dir = 2 if bidirectional else 1
    c0 = state_cell if mode == "lstm" else None
    if data.device.type == "meta":
        # shape inference: PyTorch's RNN walks every step even on meta
        # tensors (0.5 s at T = 60), so the shapes are written out
        out = data.new_empty(data.shape[:-1] + (num_dir * hidden,))
        h_t = state.new_empty((num_layers * num_dir,) + state.shape[1:])
        c_t = h_t.new_empty(h_t.shape) if mode == "lstm" else None
    else:
        out, h_t, c_t = rnn_forward(
            mode, data, (state, c0),
            unpack_params(parameters, mode, num_layers, data.shape[-1],
                          hidden, num_dir),
            bidirectional, p, generator,
            train=train or _needs_grad(data, parameters, state, c0))
    if not attrs.get_bool("state_outputs", False):
        return out
    return (out, h_t, c_t) if mode == "lstm" else (out, h_t)
