"""Jupyter-notebook training utilities (the counterpart of
`mxnet_tpu/notebook/`; reference ``python/mxnet/notebook/``)."""
from . import callback
