"""Multi-process runtime (the counterpart of `mxnet_tpu/parallel/`).

Only the process group of `distributed` is ported: ``initialize``,
``is_initialized``, ``rank``, ``size`` and ``barrier``, which the ``dist``
stores of `kvstore` need.  The meshes and the SPMD trainer come later.
"""
from . import distributed  # noqa: F401

__all__ = ["distributed"]
