"""A Gluon block as a function of its parameters (the counterpart of
`mxnet_tpu/parallel/functional.py`).

The JAX package closes a block into a pure function to jit a whole
training step.  Here the same trick gives the SPMD trainer a forward it
can differentiate with ``torch.autograd.grad`` over tensors it owns: the
block's Parameters are pointed at the given tensors for one call (in
place of ``torch.func.functional_call``, which takes an ``nn.Module``;
a Gluon block is not one) and run imperatively, hybridized blocks
included, under autograd's recording in train or predict mode.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .. import autograd
from ..cached_op import tracing_scope
from ..gluon.block import Block
from ..ndarray.ndarray import NDArray

__all__ = ["functionalize", "split_params", "tree_map", "tree_leaves"]


def split_params(block) -> Tuple[List[str], List[str]]:
    """The block's parameter names as (trainable, aux): aux are those of
    grad_req 'null' (BatchNorm's moving statistics)."""
    train, aux = [], []
    for name, p in sorted(block.collect_params().items()):
        (aux if p.grad_req == "null" else train).append(name)
    return train, aux


def functionalize(block, train_mode: bool = True):
    """``fn(params, aux, *args) -> (outs, new_aux)``: ``params`` and
    ``aux`` map names to tensors, ``args`` are tensors (or NDArrays);
    ``outs`` is the list of output tensors, ``new_aux`` every aux entry
    (the moved ones updated).  Autograd records the call, so gradients
    flow to the given tensors."""
    all_params = dict(block.collect_params().items())

    def fn(params: Dict[str, torch.Tensor], aux: Dict[str, torch.Tensor],
           *arg_arrays):
        merged = {**params, **aux}
        wrappers = {n: NDArray(t) for n, t in merged.items()}
        plist = [(all_params[n], w) for n, w in wrappers.items()]
        saved = [(p._data, p._ctx_list) for p, _ in plist]
        try:
            for p, w in plist:
                p._data = [w]
                p._ctx_list = [w.context]
            args = [a if isinstance(a, NDArray) else NDArray(a)
                    for a in arg_arrays]
            with tracing_scope(), autograd._Scope(True, train_mode):
                out = Block.__call__(block, *args)
        finally:
            for (p, _), (d, c) in zip(plist, saved):
                p._data, p._ctx_list = d, c
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        new_aux = {n: (wrappers[n].data if wrappers[n].data is not aux[n]
                       else aux[n]) for n in aux}
        return [o.data for o in outs], new_aux

    return fn


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, tree[k], *[r[k] for r in rest]))
                          for k in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, *xs) for xs in zip(tree, *rest)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)
