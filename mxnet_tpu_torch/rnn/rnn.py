"""RNN checkpoints (the counterpart of `mxnet_tpu/rnn/rnn.py`; reference
`python/mxnet/rnn/rnn.py`): a checkpoint is saved with every
`FusedRNNCell`'s packed vector unpacked into the unfused cells' weights,
so fused and unfused cells load it alike, and loading packs them again
for the cells given."""
from __future__ import annotations

from ..model import load_checkpoint, save_checkpoint

__all__ = ["rnn_unroll", "save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]


def _as_cells(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def rnn_unroll(cell, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC"):
    """The reference's deprecated alias of ``cell.unroll``
    (`rnn.py:rnn_unroll`); with ``inputs=None`` it makes the step
    variables ``{input_prefix}t{i}_data``."""
    if inputs is None:
        from ..symbol.symbol import var
        inputs = [var(f"{input_prefix}t{i}_data") for i in range(length)]
    return cell.unroll(length, inputs=inputs, begin_state=begin_state,
                       layout=layout)


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    """`model.save_checkpoint` with the cells' weights unpacked
    (reference `rnn.py:save_rnn_checkpoint`)."""
    args = dict(arg_params)
    for cell in _as_cells(cells):
        args = cell.unpack_weights(args)
    save_checkpoint(prefix, epoch, symbol, args, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """`model.load_checkpoint` with the weights packed for ``cells``
    (reference `rnn.py:load_rnn_checkpoint`): ``(symbol, arg_params,
    aux_params)``."""
    sym, arg, aux = load_checkpoint(prefix, epoch)
    for cell in _as_cells(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback saving with `save_rnn_checkpoint` every
    ``period`` epochs (reference `rnn.py:do_rnn_checkpoint`)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
