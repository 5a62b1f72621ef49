"""Model graphs the port serves and trains."""
from .bert import BERT_BASE, bert_encoder, bert_mlm, random_params  # noqa: F401
from .lstm_lm import (PTB_LSTM, foreach_lm, greedy_decoder,  # noqa: F401
                      lm_weight_names, lstm_lm, lstm_step)
from .dcgan import DCGAN, dcgan  # noqa: F401
from .ring_lm import (RING_LM_NAMES, needle_batch,  # noqa: F401
                      ring_lm_adam, ring_lm_loss, ring_lm_numpy_params)
