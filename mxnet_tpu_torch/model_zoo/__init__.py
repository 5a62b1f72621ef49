"""Model graphs the port serves."""
from .bert import BERT_BASE, bert_encoder, random_params  # noqa: F401
