"""SVRG optimization (the counterpart of
`mxnet_tpu/contrib/svrg_optimization/`; reference
`python/mxnet/contrib/svrg_optimization/`)."""
from .svrg_module import SVRGModule  # noqa: F401
