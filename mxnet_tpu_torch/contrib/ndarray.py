"""``mx.contrib.ndarray`` (reference ``python/mxnet/contrib/ndarray.py``):
the contrib operator namespace at its legacy import path,
``mx.contrib.ndarray.MultiBoxPrior(...)`` is ``mx.nd.contrib.MultiBoxPrior``."""
from ..ndarray.contrib import *  # noqa: F401,F403
from ..ndarray import contrib as _contrib


def __getattr__(name):
    return getattr(_contrib, name)
