"""Pretrained weights (the counterpart of
`mxnet_tpu/gluon/model_zoo/model_store.py`).  The repository holds no
weights and the port fetches nothing, so ``pretrained=True`` raises; a
`.params` file of the same net loads with ``load_parameters``."""
from __future__ import annotations

from ...base import MXNetError

__all__ = ["load_pretrained"]


def load_pretrained(net, name, root=None, ctx=None):
    """Reference `model_store.py`'s download-and-load tail: raises here."""
    raise MXNetError(
        f"{name}: pretrained weights are not available (the repository "
        "holds none); load a .params file with load_parameters instead")
