"""`sym.sparse` (the counterpart of `mxnet_tpu/symbol/sparse.py`;
reference `python/mxnet/symbol/sparse.py`): storage types belong to the
arrays fed at run time, so the sparse composers are `sym`'s own."""


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(name)
    from .. import symbol as _sym
    return getattr(_sym, name)
