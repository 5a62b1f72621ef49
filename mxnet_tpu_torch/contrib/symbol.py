"""``mx.contrib.symbol`` (reference ``python/mxnet/contrib/symbol.py``): the
contrib symbolic namespace at its legacy import path."""
from ..symbol.contrib import *  # noqa: F401,F403
from ..symbol import contrib as _contrib


def __getattr__(name):
    return getattr(_contrib, name)
