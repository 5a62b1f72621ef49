"""Token embeddings (the counterpart of
`mxnet_tpu/contrib/text/embedding.py`; reference
`python/mxnet/contrib/text/embedding.py`).

`CustomEmbedding` loads any whitespace token-vector file; `GloVe` /
`FastText` read their published files from ``$MXNET_HOME/embeddings``,
where they must already be placed: nothing is fetched, and a missing file
raises with its source's name.  `CompositeEmbedding` concatenates
sources.  ``idx_to_vec`` lives on the embedding's context (the current
context when it was made: the card unless the caller opened ``with
cpu():``); `get_vecs_by_tokens` and `update_token_vectors` gather and
write its rows there, so the result drops straight into
`gluon.nn.Embedding.weight`."""
from __future__ import annotations

import io
import os
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ...base import MXNetError
from ...config import get_env
from ...context import current_context
from ... import ndarray as nd
from ...ndarray.ndarray import NDArray
from .vocab import Vocabulary

__all__ = ["register", "create", "list_embedding_names", "TokenEmbedding",
           "CustomEmbedding", "CompositeEmbedding", "GloVe", "FastText"]

_REGISTRY: Dict[str, type] = {}


def register(cls):
    """Register an embedding class under its lowercase name (reference
    `embedding.py:register`)."""
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(embedding_name: str, **kwargs):
    name = embedding_name.lower()
    if name not in _REGISTRY:
        raise MXNetError(
            f"unknown embedding {embedding_name!r}; registered: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def list_embedding_names() -> List[str]:
    return sorted(_REGISTRY)


class TokenEmbedding:
    """Base: an indexed token table + an (n, dim) embedding matrix."""

    def __init__(self, unknown_token: str = "<unk>",
                 init_unknown_vec: Callable = None):
        self._unknown_token = unknown_token
        self._init_unknown_vec = init_unknown_vec or (lambda s: np.zeros(s))
        self._idx_to_token: List[str] = [unknown_token]
        self._token_to_idx: Dict[str, int] = {unknown_token: 0}
        self._idx_to_vec = None  # NDArray (n, dim)
        self._ctx = current_context()

    # -- loading ---------------------------------------------------------
    def _load_embedding_file(self, path, elem_delim=" ", encoding="utf8"):
        vecs = []
        dim = None
        with io.open(path, "r", encoding=encoding) as f:
            for line_num, line in enumerate(f):
                parts = line.rstrip().split(elem_delim)
                if len(parts) < 2:
                    continue
                token, elems = parts[0], parts[1:]
                if dim is None and len(elems) > 1:
                    dim = len(elems)
                if len(elems) == 1 and line_num == 0:
                    continue  # fastText-style header line
                if len(elems) != dim:
                    raise MXNetError(
                        f"line {line_num} of {path}: expected {dim} values, "
                        f"got {len(elems)}")
                if token in self._token_to_idx:
                    continue
                self._token_to_idx[token] = len(self._idx_to_token)
                self._idx_to_token.append(token)
                vecs.append(np.asarray([float(e) for e in elems],
                                       np.float32))
        if dim is None:
            raise MXNetError(f"no vectors found in {path}")
        mat = np.vstack([self._init_unknown_vec((dim,)).astype(np.float32)]
                        + vecs)
        self._idx_to_vec = nd.array(mat, ctx=self._ctx)

    # -- surface ---------------------------------------------------------
    def __len__(self):
        return len(self._idx_to_token)

    @property
    def vec_len(self) -> int:
        return 0 if self._idx_to_vec is None else self._idx_to_vec.shape[1]

    @property
    def idx_to_vec(self):
        return self._idx_to_vec

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    def get_vecs_by_tokens(self, tokens: Union[str, Sequence[str]],
                           lower_case_backup: bool = False):
        """Vector(s) for token(s); unknowns get the unknown vector."""
        single = isinstance(tokens, str)
        toks = [tokens] if single else list(tokens)
        idxs = []
        for t in toks:
            i = self._token_to_idx.get(t)
            if i is None and lower_case_backup:
                i = self._token_to_idx.get(t.lower())
            idxs.append(0 if i is None else i)
        table = self._idx_to_vec.data
        rows = torch.tensor(idxs, dtype=torch.int64, device=table.device)
        vecs = table.index_select(0, rows)
        return NDArray(vecs[0] if single else vecs, self._ctx)

    def update_token_vectors(self, tokens: Union[str, Sequence[str]],
                             new_vectors):
        toks = [tokens] if isinstance(tokens, str) else list(tokens)
        for t in toks:
            if t not in self._token_to_idx:
                raise MXNetError(
                    f"token {t!r} is unknown; only vectors of indexed "
                    "tokens can be updated")
        table = self._idx_to_vec.data.clone()
        new = (new_vectors.data if isinstance(new_vectors, NDArray)
               else torch.as_tensor(np.asarray(new_vectors, np.float32)))
        new = new.to(table.device, table.dtype).reshape(len(toks), -1)
        rows = torch.tensor([self._token_to_idx[t] for t in toks],
                            dtype=torch.int64, device=table.device)
        table[rows] = new
        self._idx_to_vec = NDArray(table, self._ctx)


@register
class CustomEmbedding(TokenEmbedding):
    """User-supplied embedding file: `token<delim>v1<delim>...vN` per line
    (reference `embedding.py:CustomEmbedding`)."""

    def __init__(self, pretrained_file_path, elem_delim=" ",
                 encoding="utf8", vocabulary: Optional[Vocabulary] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self._load_embedding_file(pretrained_file_path, elem_delim, encoding)
        if vocabulary is not None:
            self._restrict_to(vocabulary)

    def _restrict_to(self, vocab: Vocabulary):
        table = self._idx_to_vec.data
        rows = torch.tensor([self._token_to_idx.get(t, 0)
                             for t in vocab.idx_to_token],
                            dtype=torch.int64, device=table.device)
        self._idx_to_vec = NDArray(table.index_select(0, rows), self._ctx)
        self._idx_to_token = list(vocab.idx_to_token)
        self._token_to_idx = dict(vocab.token_to_idx)


class _DownloadedEmbedding(TokenEmbedding):
    """Shared base for published embeddings: resolve the file from the
    cache dir, with an actionable error when it must be fetched offline."""

    source_file_names: Dict[str, str] = {}

    def __init__(self, pretrained_file_name: str, **kwargs):
        super().__init__(**kwargs)
        if pretrained_file_name not in self.source_file_names:
            raise MXNetError(
                f"unknown pretrained file {pretrained_file_name!r}; "
                f"available: {sorted(self.source_file_names)}")
        root = os.path.join(get_env("MXNET_HOME"), "embeddings",
                            type(self).__name__.lower())
        path = os.path.join(root, pretrained_file_name)
        if not os.path.exists(path):
            raise MXNetError(
                f"pretrained embedding file {path} not found; nothing is "
                "downloaded here: fetch "
                f"{self.source_file_names[pretrained_file_name]} and place "
                f"the extracted text file there.")
        self._load_embedding_file(path)

    @classmethod
    def get_pretrained_file_names(cls):
        return sorted(cls.source_file_names)


@register
class GloVe(_DownloadedEmbedding):
    source_file_names = {
        "glove.6B.50d.txt": "http://nlp.stanford.edu/data/glove.6B.zip",
        "glove.6B.100d.txt": "http://nlp.stanford.edu/data/glove.6B.zip",
        "glove.6B.200d.txt": "http://nlp.stanford.edu/data/glove.6B.zip",
        "glove.6B.300d.txt": "http://nlp.stanford.edu/data/glove.6B.zip",
        "glove.42B.300d.txt": "http://nlp.stanford.edu/data/glove.42B.300d.zip",
        "glove.840B.300d.txt": "http://nlp.stanford.edu/data/glove.840B.300d.zip",
    }


@register
class FastText(_DownloadedEmbedding):
    source_file_names = {
        "wiki.simple.vec":
            "https://dl.fbaipublicfiles.com/fasttext/vectors-wiki/wiki.simple.vec",
        "wiki.en.vec":
            "https://dl.fbaipublicfiles.com/fasttext/vectors-wiki/wiki.en.vec",
    }


class CompositeEmbedding(TokenEmbedding):
    """Concatenates several embeddings over one vocabulary (reference
    `embedding.py:CompositeEmbedding`)."""

    def __init__(self, vocabulary: Vocabulary,
                 token_embeddings: Sequence[TokenEmbedding]):
        super().__init__(unknown_token=vocabulary.unknown_token)
        if isinstance(token_embeddings, TokenEmbedding):
            # reference accepts a bare embedding as well as a list
            token_embeddings = [token_embeddings]
        self._idx_to_token = list(vocabulary.idx_to_token)
        self._token_to_idx = dict(vocabulary.token_to_idx)
        parts = [emb.get_vecs_by_tokens(self._idx_to_token).data
                 .to(self._ctx.device) for emb in token_embeddings]
        self._idx_to_vec = NDArray(torch.cat(parts, dim=1), self._ctx)
        self.token_embeddings = list(token_embeddings)
