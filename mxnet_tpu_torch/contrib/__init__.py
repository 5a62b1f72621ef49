"""``mx.contrib`` (the counterpart of `mxnet_tpu/contrib/`; reference
`python/mxnet/contrib/`): int8 quantization with its calibration, the
TensorBoard callback, `text` (vocabularies and token embeddings), SVRG,
ONNX import and export, the TensorRT flag surface, the legacy autograd
API, `DataLoaderIter`, and the contrib op namespaces at their legacy
import paths (``mx.contrib.ndarray`` is ``mx.nd.contrib``)."""
from . import quantization
from . import tensorboard
from . import text
from . import svrg_optimization
from . import onnx
from . import autograd
from . import io
from . import ndarray
from . import symbol
from . import tensorrt

__all__ = ["quantization", "tensorboard", "text", "svrg_optimization",
           "onnx", "autograd", "io", "ndarray", "symbol", "tensorrt"]
