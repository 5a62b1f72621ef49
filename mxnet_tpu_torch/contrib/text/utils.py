"""Text helpers (the counterpart of `mxnet_tpu/contrib/text/utils.py`;
reference `python/mxnet/contrib/text/utils.py`)."""
import collections
import re


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """Token frequencies from a delimited corpus string (reference
    `utils.py:count_tokens_from_str`).  Delimiters are treated as
    LITERAL strings (escaped), split on either, like the reference's
    `re.split(token_delim + '|' + seq_delim)` on its default literal
    delimiters — metacharacter or multi-char delimiters tokenize
    correctly."""
    tokens = re.split(
        re.escape(token_delim) + "|" + re.escape(seq_delim), source_str)
    if to_lower:
        tokens = [t.lower() for t in tokens]
    counter = (collections.Counter() if counter_to_update is None
               else counter_to_update)
    counter.update(t for t in tokens if t)
    return counter
