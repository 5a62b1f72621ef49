"""Text vocabulary (the counterpart of `mxnet_tpu/contrib/text/vocab.py`;
reference `python/mxnet/contrib/text/vocab.py`).

Indexes tokens by frequency with reserved tokens and an unknown token at
index 0 — the contract `TokenEmbedding` and `to_indices/to_tokens` build
on."""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Union

__all__ = ["Vocabulary"]


class Vocabulary:
    """Frequency-indexed vocabulary.

    `counter` maps token -> count (e.g. `collections.Counter` over a
    corpus). Tokens below `min_freq` or beyond `most_freq_count` are
    dropped; lookups of unindexed tokens resolve to `unknown_token`'s
    index 0 (reference vocab.py:Vocabulary)."""

    def __init__(self, counter: Optional[collections.Counter] = None,
                 most_freq_count: Optional[int] = None, min_freq: int = 1,
                 unknown_token: str = "<unk>",
                 reserved_tokens: Optional[Sequence[str]] = None):
        # AssertionError on bad arguments, like the reference
        # (`contrib/text/vocab.py` uses bare asserts; ported user code
        # catches AssertionError)
        assert min_freq >= 1, "`min_freq` must be set to a positive value."
        reserved_tokens = list(reserved_tokens or [])
        assert len(set(reserved_tokens)) == len(reserved_tokens), \
            "`reserved_tokens` cannot contain duplicates."
        assert unknown_token not in reserved_tokens, \
            "`reserved_tokens` cannot contain `unknown_token`."
        self._unknown_token = unknown_token
        self._reserved_tokens = reserved_tokens or None
        self._idx_to_token: List[str] = [unknown_token] + reserved_tokens
        self._token_to_idx: Dict[str, int] = {
            t: i for i, t in enumerate(self._idx_to_token)}
        if counter:
            self._index_counter_keys(counter, most_freq_count, min_freq)

    def _index_counter_keys(self, counter, most_freq_count, min_freq):
        pairs = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
        kept = 0
        for token, freq in pairs:
            if freq < min_freq:
                break
            if most_freq_count is not None and kept >= most_freq_count:
                break
            if token not in self._token_to_idx:
                self._token_to_idx[token] = len(self._idx_to_token)
                self._idx_to_token.append(token)
                kept += 1

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens: Union[str, Sequence[str]]):
        """Token(s) -> index/indices; unknown tokens map to index 0."""
        single = isinstance(tokens, str)
        toks = [tokens] if single else list(tokens)
        out = [self._token_to_idx.get(t, 0) for t in toks]
        return out[0] if single else out

    def to_tokens(self, indices: Union[int, Sequence[int]]):
        single = isinstance(indices, int)
        idxs = [indices] if single else list(indices)
        out = []
        for i in idxs:
            if not 0 <= i < len(self._idx_to_token):
                raise ValueError(f"token index {i} out of range")
            out.append(self._idx_to_token[i])
        return out[0] if single else out
