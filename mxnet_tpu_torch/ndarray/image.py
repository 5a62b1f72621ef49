"""`mx.nd.image` (the counterpart of `mxnet_tpu/ndarray/image.py`;
reference `python/mxnet/ndarray/image.py`): friendly names over the
``_image_*`` registry ops (resize, crop, to_tensor, normalize, flips,
jitter)."""
from ..ops.registry import attach_prefixed
from .register import invoke

__all__ = []

attach_prefixed(globals(), ("_image_",), invoke, target_all=__all__)
