"""Checkpoints and the legacy ``FeedForward`` (the counterpart of
`mxnet_tpu/model.py`; reference `python/mxnet/model.py`).

A checkpoint is two files, the reference's and the JAX package's:
``prefix-symbol.json`` (the graph) and ``prefix-NNNN.params`` (the
NDArray blob of `serialization`, keys ``arg:<name>`` and ``aux:<name>``),
so a checkpoint written by either package loads in the other.  Loaded
arrays stay on the host as CPU NDArrays; binding copies them where the
module runs.
"""
from __future__ import annotations

import logging
from typing import Dict, Tuple

from .serialization import load_ndarrays, save_ndarrays

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "FeedForward"]


def save_checkpoint(prefix: str, epoch: int, symbol, arg_params: Dict,
                    aux_params: Dict):
    """Reference `model.py:save_checkpoint`: the symbol (when given) and
    the parameters of ``epoch``."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    payload = {f"arg:{k}": v for k, v in (arg_params or {}).items()}
    payload.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
    save_ndarrays(f"{prefix}-{epoch:04d}.params", payload)


def load_checkpoint(prefix: str, epoch: int):
    """Reference `model.py:load_checkpoint`: ``(symbol, arg_params,
    aux_params)``."""
    from .symbol import load as sym_load
    symbol = sym_load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params


def load_params(prefix: str, epoch: int) -> Tuple[Dict, Dict]:
    """The ``.params`` file of ``epoch`` split into ``(arg_params,
    aux_params)``; a key with neither prefix counts as an argument, with
    a warning when the file mixes both kinds."""
    fname = f"{prefix}-{epoch:04d}.params"
    loaded = load_ndarrays(fname)
    arg_params, aux_params = {}, {}
    strays = []
    for k, v in loaded.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            strays.append(k)
            arg_params[k] = v
    if strays and len(strays) != len(loaded):
        logging.warning(
            "checkpoint %s mixes arg:/aux:-prefixed and bare keys; "
            "folded %d stray key(s) into arg_params: %s",
            fname, len(strays), sorted(strays))
    return arg_params, aux_params


class FeedForward:
    """The reference's legacy training API (`model.py:FeedForward`,
    deprecated there for Module), a thin wrapper over `mod.Module`."""

    def __init__(self, symbol, ctx=None, num_epoch=None, optimizer="sgd",
                 initializer=None, arg_params=None, aux_params=None,
                 learning_rate=0.01, **kwargs):
        self.symbol = symbol
        self._num_epoch = num_epoch
        self._optimizer = optimizer
        self._init = initializer
        self._opt_params = {"learning_rate": learning_rate}
        self._opt_params.update({k: v for k, v in kwargs.items()
                                 if k in ("momentum", "wd", "rescale_grad",
                                          "clip_gradient")})
        self._arg_params = arg_params
        self._aux_params = aux_params
        self._ctx = ctx
        self._module = None

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None):
        from .io import NDArrayIter
        from .module import Module
        if not hasattr(X, "provide_data"):
            X = NDArrayIter(X, y, batch_size=128)
        label_names = [d.name for d in (X.provide_label or [])]
        self._module = Module(self.symbol,
                              data_names=[d.name for d in X.provide_data],
                              label_names=label_names, context=self._ctx)
        self._module.fit(X, eval_data=eval_data, eval_metric=eval_metric,
                         epoch_end_callback=epoch_end_callback,
                         batch_end_callback=batch_end_callback,
                         kvstore=kvstore, optimizer=self._optimizer,
                         optimizer_params=self._opt_params,
                         initializer=self._init,
                         arg_params=self._arg_params,
                         aux_params=self._aux_params,
                         num_epoch=self._num_epoch)
        return self

    def predict(self, X, num_batch=None):
        return self._module.predict(X, num_batch=num_batch)

    def score(self, X, eval_metric="acc", num_batch=None):
        return self._module.score(X, eval_metric, num_batch=num_batch)

    def save(self, prefix, epoch=None):
        arg, aux = self._module.get_params()
        if epoch is None:
            epoch = self._num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol, arg, aux)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        sym, arg, aux = load_checkpoint(prefix, epoch)
        return FeedForward(sym, ctx=ctx, arg_params=arg, aux_params=aux,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               **kwargs):
        """Construct and fit in one call (reference
        `model.py:FeedForward.create`)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            optimizer=optimizer, initializer=initializer,
                            **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback,
                  kvstore=kvstore, logger=logger)
        return model
