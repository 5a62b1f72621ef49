"""``mx.contrib`` (the counterpart of `mxnet_tpu/contrib/`; reference
`python/mxnet/contrib/`): int8 quantization with its calibration, the
legacy autograd API, `DataLoaderIter`, and the contrib op namespaces at
their legacy import paths (``mx.contrib.ndarray`` is ``mx.nd.contrib``).
The rest of the reference's ``contrib`` (tensorboard, text, svrg, onnx,
tensorrt) is not ported yet."""
from . import quantization
from . import autograd
from . import io
from . import ndarray
from . import symbol

__all__ = ["quantization", "autograd", "io", "ndarray", "symbol"]
