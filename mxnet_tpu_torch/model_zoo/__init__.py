"""Model graphs the port serves and trains."""
from .bert import BERT_BASE, bert_encoder, bert_mlm, random_params  # noqa: F401
from .lstm_lm import PTB_LSTM, lstm_lm  # noqa: F401
