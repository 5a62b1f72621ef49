"""Text utilities (the counterpart of `mxnet_tpu/contrib/text/`; reference
`python/mxnet/contrib/text/`)."""
from . import embedding, utils, vocab  # noqa: F401
from .embedding import *  # noqa: F401,F403
from .utils import count_tokens_from_str  # noqa: F401
from .vocab import Vocabulary  # noqa: F401
