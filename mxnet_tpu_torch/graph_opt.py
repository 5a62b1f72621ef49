"""Graph optimizer: rewrite passes over the bound Symbol graph (the
counterpart of `mxnet_tpu/graph_opt.py`), under the JAX package's pass
names, in its order, with its rewrites, details and parity labels, so the
two packages' reports compare one to one.

Inference passes, in order:

* **fold_const** -- subgraphs whose inputs are all constants (roots:
  the zero-input constructors ``_zeros``/``_ones``/``_full``/``_arange``/
  ``_eye``) run once at build through `registry.apply_op`, the dispatch
  the executor uses, so folding is bitwise; their values enter the
  program as ``const_feed`` inputs, under ``MXTPU_GRAPH_OPT_FOLD_MAX_MB``.
* **fold_bn** -- eval-mode BatchNorm folds into the FullyConnected or
  Convolution before it, as graph nodes over the same parameter
  variables (``W' = W·scale``, ``b' = beta + (b - mm)·scale``, ``scale =
  gamma·rsqrt(mv + eps)``): an algebraic rewrite, parity within ULP.
* **eliminate** -- inverse transpose/swapaxes pairs, identity-axes
  transposes, reshape∘reshape chains, identity/_copy (and, on inference
  graphs, BlockGrad) forwarding.
* **cse** -- common-subexpression elimination keyed by (op, canonical
  attrs, input entries); ops that draw random numbers or mutate inputs
  never merge.
* **pallas_select** -- pattern-matches two idioms and swaps in the ops of
  `ops/hopper_kernels.py`: MXNet's attention
  ``batch_dot(softmax(batch_dot(Q, Kᵀ)[·s]), V)`` → `_fused_attention`
  (K1), when the reference's flop count (XLA's cost analysis of the
  unfused lowering, in closed form: ``4·B·Lq·Lk·d + B·Lq·(4·Lk - 1)``)
  clears ``MXTPU_PALLAS_MIN_FLOPS``; and the unfused LSTM cell of
  `rnn.LSTMCell` → `_fused_lstm_gates` (K4), at every site.  The op takes
  rank 3 and 4 alike, so a rank-3 site needs none of the reference's
  reshape shims.  Behind ``MXTPU_PALLAS``: ``auto`` swaps only when the
  bound device is CUDA with compute capability (9, 0), ``1`` on any
  device, ``0`` never.  A site keeps its unfused graph by the JAX
  package's rules alone (a ragged sequence, see
  `hopper_kernels.check_attention`; gates not of rank 2).  On CUDA a site
  the kernel is not built for (an attention head dim, an LSTM dtype other
  than float32 or bfloat16) makes the bind fail: ``MXTPU_PALLAS=0`` is
  then the caller's choice, never a silent one.

Training graphs run ``eliminate`` (BlockGrad kept), ``cse`` and
``dead_aux`` (identity forwarding only), or with ``MXTPU_UNIFIED_STEP=0``
the legacy ``cse`` and ``dead_aux``; `training_result` checks that a
rewrite kept the output count, the random-number nodes and the aux
state set.

Every pass is pure: the input symbol is never modified, and untouched
regions are shared by identity with the result.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import config
from . import profiler as _prof
from .attribute import strip_annotations
from .base import MXNetError
from .ops import registry as _reg
from .ops.hopper_kernels import (check_attention, check_kernel_inputs,
                                 check_lstm_kernel_inputs)
from .ops.registry import Attrs, canonical_attrs
from .symbol.symbol import Symbol, _Node, _infer_graph, _topo, _value_key

__all__ = ["PassReport", "PipelineResult", "optimize", "graph_opt_enabled",
           "skipped_passes", "pallas_mode", "train_passes", "training_result",
           "training_symbol", "verify_bitwise",
           "INFER_PASSES", "TRAIN_PASSES", "TRAIN_PASSES_UNIFIED"]


def graph_opt_enabled() -> bool:
    """Pipeline kill switch (``MXTPU_GRAPH_OPT``, default on)."""
    return config.get_env("MXTPU_GRAPH_OPT", "1").strip().lower() \
        not in ("0", "false", "off")


def skipped_passes() -> frozenset:
    """Per-pass disable set (``MXTPU_GRAPH_OPT_SKIP=pallas_select``)."""
    raw = config.get_env("MXTPU_GRAPH_OPT_SKIP", "")
    return frozenset(t.strip() for t in raw.split(",") if t.strip())


def pallas_mode() -> str:
    """``MXTPU_PALLAS``: 'auto', '1'/'on' or '0'/'off'."""
    return config.get_env("MXTPU_PALLAS", "auto").strip().lower()


@dataclass
class PassReport:
    """Structured result of one pass run on one graph."""
    name: str
    nodes_before: int
    nodes_after: int
    rewrites: int
    wall_ms: float
    #: "bitwise" (value-identical by construction) or "ulp" (kernel swap:
    #: parity within a documented float tolerance)
    parity: str
    details: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


@dataclass
class PipelineResult:
    """The optimized symbol, the constants it now feeds on (to be merged
    into every feed of it), and the per-pass reports."""
    symbol: Any
    const_feed: Dict[str, torch.Tensor]
    reports: List[PassReport]
    enabled: bool

    def report_dicts(self) -> List[Dict[str, Any]]:
        return [r.to_dict() for r in self.reports]


# ---------------------------------------------------------------------------
# rewrite machinery
# ---------------------------------------------------------------------------

def _n_compute(symbol) -> int:
    return sum(1 for n in _topo(symbol._heads) if not n.is_var)


def _var_names(symbol) -> set:
    return {n.name for n in _topo(symbol._heads) if n.is_var}


def _node_attrs(node) -> Attrs:
    return Attrs(strip_annotations(node.attrs))


class _Ctx:
    """Fresh-name allocator for nodes a pass creates (names key the
    executor's value dict, so they stay unique within the graph)."""

    def __init__(self, symbol):
        self._names = {n.name for n in _topo(symbol._heads)}
        self._i = 0

    def name(self, hint: str) -> str:
        while True:
            nm = f"__opt_{hint}_{self._i}"
            self._i += 1
            if nm not in self._names:
                self._names.add(nm)
                return nm


def _substitute(symbol, entry_map):
    """Memoized clone of the DAG applying an entry-level substitution map
    ``{(id(node), out_idx): (replacement_node, out_idx)}``.  Replacement
    nodes may reference original nodes in their inputs; untouched nodes
    are kept by identity."""
    if not entry_map:
        return symbol
    memo: Dict[int, Any] = {}

    def resolve(entry):
        node, idx = entry
        hops = 0
        while (id(node), idx) in entry_map:
            node, idx = entry_map[(id(node), idx)]
            hops += 1
            if hops > 100000:
                raise MXNetError("graph_opt: cyclic entry substitution")
        return node, idx

    def rebuild(root):
        # depth-first over the RESOLVED edges, with an explicit stack so
        # deep graphs need no recursion
        stack = [root]
        while stack:
            node = stack[-1]
            if id(node) in memo:
                stack.pop()
                continue
            if node.is_var:
                memo[id(node)] = node
                stack.pop()
                continue
            ins = [resolve(e) for e in node.inputs]
            pending = [n for (n, _) in ins if id(n) not in memo]
            if pending:
                stack.extend(pending)
                continue
            new_inputs = [(memo[id(n)], i) for (n, i) in ins]
            same = all(a is b and ai == bi for (a, ai), (b, bi)
                       in zip(new_inputs, node.inputs))
            memo[id(node)] = node if same else _Node(
                node.op, node.name, dict(node.attrs), new_inputs)
            stack.pop()
        return memo[id(root)]

    heads = [resolve(e) for e in symbol._heads]
    return Symbol([(rebuild(n), i) for (n, i) in heads])


def _consumer_counts(symbol) -> Dict[Tuple[int, int], int]:
    """(id(node), out_idx) -> number of consuming slots (+1 per head)."""
    counts: Dict[Tuple[int, int], int] = {}
    for n in _topo(symbol._heads):
        for (inp, idx) in n.inputs:
            k = (id(inp), idx)
            counts[k] = counts.get(k, 0) + 1
    for (node, idx) in symbol._heads:
        k = (id(node), idx)
        counts[k] = counts.get(k, 0) + 1
    return counts


def _infer_entries(symbol, shapes, dtypes=None):
    """``({(id(node), out_idx): shape}, {(id(node), out_idx): dtype})`` for
    every entry inference can resolve from the input ``shapes`` (and
    ``dtypes``, float32 where not given); ({}, {}) when it cannot run."""
    if not shapes:
        return {}, {}
    known = {k: tuple(v) for k, v in shapes.items() if v is not None}
    try:
        by_key, dtype_by_key = _infer_graph(symbol._heads, known, True,
                                            dtypes)
    except MXNetError:
        return {}, {}
    entry_shapes, entry_dtypes = {}, {}
    for node in _topo(symbol._heads):
        for i in range(node.num_outputs):
            key = _value_key((node, i))
            if by_key.get(key) is not None:
                entry_shapes[(id(node), i)] = tuple(by_key[key])
                entry_dtypes[(id(node), i)] = dtype_by_key[key]
    return entry_shapes, entry_dtypes


# ---------------------------------------------------------------------------
# fold_const
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _pass_fold_const(symbol, train, ctx, const_feed):
    """Evaluate variable-free subgraphs once at build.  A node is constant
    when all its inputs are and it neither draws random numbers, reads
    train mode nor mutates inputs; the constant entries that feed the rest
    of the graph become variables with their values in ``const_feed``."""
    nodes = _topo(symbol._heads)
    is_const: Dict[int, bool] = {}
    for n in nodes:
        if n.is_var:
            is_const[id(n)] = False
            continue
        op = _reg.get_op(n.op)
        if op.needs_rng or op.uses_train_mode or \
                op.mutate_slots(_node_attrs(n)):
            is_const[id(n)] = False
            continue
        is_const[id(n)] = all(is_const[id(i)] for (i, _) in n.inputs)

    frontier, seen = [], set()

    def note(entry):
        node, idx = entry
        if is_const.get(id(node)) and (id(node), idx) not in seen:
            seen.add((id(node), idx))
            frontier.append(entry)

    for n in nodes:
        if n.is_var or is_const[id(n)]:
            continue
        for e in n.inputs:
            note(e)
    for e in symbol._heads:
        note(e)
    if not frontier:
        return symbol, 0, "bitwise", {}

    vals: Dict[Tuple[int, int], torch.Tensor] = {}
    with torch.inference_mode():
        for n in nodes:
            if n.is_var or not is_const[id(n)]:
                continue
            ins = [vals[(id(i), idx)] for (i, idx) in n.inputs]
            outs = _reg.apply_op(n.op, ins, strip_annotations(n.attrs))
            for i, o in enumerate(outs):
                vals[(id(n), i)] = o

    cap_mb = config.get_env("MXTPU_GRAPH_OPT_FOLD_MAX_MB", 64)
    total = sum(_nbytes(vals[(id(n), i)]) for (n, i) in frontier)
    if total > int(cap_mb) * (1 << 20):
        return symbol, 0, "bitwise", {
            "skipped": f"folded constants {total}B exceed "
                       f"MXTPU_GRAPH_OPT_FOLD_MAX_MB={cap_mb}"}
    entry_map, folded = {}, []
    for (node, idx) in frontier:
        name = ctx.name("const")
        const_feed[name] = vals[(id(node), idx)]
        entry_map[(id(node), idx)] = (_Node(None, name, {}, []), 0)
        folded.append(f"{node.name}#{idx}")
    return _substitute(symbol, entry_map), len(frontier), "bitwise", {
        "folded_entries": folded, "const_bytes": total}


# ---------------------------------------------------------------------------
# fold_bn
# ---------------------------------------------------------------------------

def _pass_fold_bn(symbol, train, ctx, const_feed):
    """Fold eval-mode BatchNorm into the single-consumer FullyConnected or
    Convolution before it, as graph nodes over the same parameter
    variables (reloading parameters keeps working):

        scale = gamma · rsqrt(moving_var + eps)     (gamma ≡ 1 if fix_gamma)
        W'    = W · reshape(scale, (C, 1, ...))
        b'    = beta + (b − moving_mean) · scale    (b ≡ 0 if no_bias)

    Only a BatchNorm that emits output 0 alone (no output_mean_var)
    folds; its eval-mode aux writes are identities."""
    if train:
        return symbol, 0, "ulp", {"skipped": "training graph"}
    nodes = _topo(symbol._heads)
    counts = _consumer_counts(symbol)
    entry_map, folded = {}, []

    def mk(op, inputs, hint, **attrs):
        return _Node(op, ctx.name(hint), dict(attrs), list(inputs))

    for bn in nodes:
        if bn.is_var or bn.op != "BatchNorm":
            continue
        a = _node_attrs(bn)
        if a.get_bool("output_mean_var", False):
            continue
        if any(counts.get((id(bn), i), 0) for i in range(1, bn.num_outputs)):
            continue
        axis = a.get_int("axis", 1)
        prev, pidx = bn.inputs[0]
        if prev.is_var or pidx != 0 or (id(prev), 0) not in counts:
            continue
        if prev.op not in ("Convolution", "FullyConnected"):
            continue
        if counts[(id(prev), 0)] != 1 or (id(prev), 0) in entry_map:
            continue
        pa = _node_attrs(prev)
        if prev.op == "Convolution":
            kernel = pa.get_tuple("kernel", None)
            if (pa.get_str("layout", None) or "NCHW") != "NCHW" \
                    or axis != 1 or kernel is None:
                continue
            w_rank = 2 + len(kernel)
        else:
            if axis not in (1, -1):
                continue
            w_rank = 2
        gamma_e, beta_e, mm_e, mv_e = bn.inputs[1:5]
        inv = mk("rsqrt", [(mk("_plus_scalar", [mv_e], "bn_eps",
                               scalar=a.get_float("eps", 1e-3)), 0)],
                 "bn_inv")
        scale_e = (inv, 0)
        if not a.get_bool("fix_gamma", True):
            scale_e = (mk("broadcast_mul", [gamma_e, scale_e], "bn_scale"),
                       0)
        scale_r = mk("reshape", [scale_e], "bn_scale_r",
                     shape=(-1,) + (1,) * (w_rank - 1))
        w_new = mk("broadcast_mul", [prev.inputs[1], (scale_r, 0)], "bn_w")
        if pa.get_bool("no_bias", False):
            b_new = mk("broadcast_sub",
                       [beta_e, (mk("broadcast_mul", [mm_e, scale_e],
                                    "bn_mmsc"), 0)], "bn_b")
        else:
            diff = mk("broadcast_sub", [prev.inputs[2], mm_e], "bn_bm")
            b_new = mk("broadcast_add",
                       [beta_e, (mk("broadcast_mul", [(diff, 0), scale_e],
                                    "bn_bmsc"), 0)], "bn_b")
        new_attrs = dict(prev.attrs)
        new_attrs["no_bias"] = False
        fused = _Node(prev.op, ctx.name(prev.op.lower()), new_attrs,
                      [prev.inputs[0], (w_new, 0), (b_new, 0)])
        entry_map[(id(bn), 0)] = (fused, 0)
        folded.append(f"{prev.name}+{bn.name}")
    if not entry_map:
        return symbol, 0, "ulp", {}
    return _substitute(symbol, entry_map), len(folded), "ulp", {
        "folded": folded,
        "note": "algebraic rewrite: parity within float ULP, verified "
                "at rtol/atol 1e-5 by tests/test_graph_opt.py; eval-mode "
                "BN identity aux writes dropped"}


# ---------------------------------------------------------------------------
# eliminate, dead_aux and cse
# ---------------------------------------------------------------------------

def _pass_eliminate(symbol, train, ctx, const_feed, safe_only=False):
    """Layout-pair and no-op elimination.  ``safe_only`` (the training
    list's ``dead_aux``) forwards identity/_copy alone; the full pass also
    removes inverse transpose/swapaxes pairs and identity-axes
    transposes, collapses reshape∘reshape chains, and on inference graphs
    forwards BlockGrad/stop_gradient.  Dead nodes and orphaned variables
    drop out in the rebuild."""
    nodes = _topo(symbol._heads)
    vars_before = _var_names(symbol)
    entry_map, removed = {}, []
    fwd_ops = {"identity", "_copy"}
    if not train and not safe_only:
        fwd_ops |= {"BlockGrad", "stop_gradient"}

    def axes_of(node):
        return _node_attrs(node).get_tuple("axes", None)

    for n in nodes:
        if n.is_var:
            continue
        if n.op in fwd_ops:
            entry_map[(id(n), 0)] = n.inputs[0]
            removed.append(n.name)
            continue
        if safe_only:
            continue
        inp, iidx = n.inputs[0] if n.inputs else (None, 0)
        chained = inp is not None and not inp.is_var and iidx == 0 \
            and inp.op == n.op and (id(inp), 0) not in entry_map
        if n.op == "transpose":
            ax = axes_of(n)
            if ax is not None and tuple(ax) == tuple(range(len(ax))):
                entry_map[(id(n), 0)] = n.inputs[0]
                removed.append(n.name)
                continue
            if chained:
                in_ax = axes_of(inp)
                if (ax is None and in_ax is None) or (
                        ax is not None and in_ax is not None
                        and len(ax) == len(in_ax)
                        and all(in_ax[ax[k]] == k for k in range(len(ax)))):
                    entry_map[(id(n), 0)] = inp.inputs[0]
                    removed.append(n.name)
                    continue
        if n.op == "swapaxes" and chained:
            a, ia = _node_attrs(n), _node_attrs(inp)
            if {a.get_int("dim1", 0), a.get_int("dim2", 0)} == \
                    {ia.get_int("dim1", 0), ia.get_int("dim2", 0)}:
                entry_map[(id(n), 0)] = inp.inputs[0]
                removed.append(n.name)
                continue
        if n.op == "reshape" and chained:
            a = _node_attrs(n)
            shape = a.get_tuple("shape", None)
            if shape is not None and not a.get_bool("reverse", False) \
                    and all(int(s) > 0 or int(s) == -1 for s in shape):
                nn = _Node("reshape", ctx.name("reshape"),
                           {"shape": tuple(shape)}, [inp.inputs[0]])
                entry_map[(id(n), 0)] = (nn, 0)
                removed.append(inp.name)

    new_sym = _substitute(symbol, entry_map)
    dropped_vars = sorted(vars_before - _var_names(new_sym))
    details: Dict[str, Any] = {}
    if removed:
        details["removed"] = removed
    if dropped_vars:
        details["dropped_vars"] = dropped_vars
    return new_sym, len(removed), "bitwise", details


def _pass_dead_aux(symbol, train, ctx, const_feed):
    return _pass_eliminate(symbol, train, ctx, const_feed, safe_only=True)


def _pass_cse(symbol, train, ctx, const_feed):
    """Merge nodes of one (op, canonical attrs, input entries) key.  A
    duplicate and its keeper share their input subtrees by identity, so
    removing the duplicate reorders no surviving random-number node."""
    nodes = _topo(symbol._heads)
    sub: Dict[int, Any] = {}
    seen: Dict[Any, Any] = {}
    entry_map, merged = {}, []
    for n in nodes:
        if n.is_var:
            continue
        op = _reg.get_op(n.op)
        stripped = strip_annotations(n.attrs)
        if op.needs_rng or op.mutate_slots(Attrs(stripped)):
            continue
        rins = tuple((id(sub.get(id(i), i)), idx) for (i, idx) in n.inputs)
        try:
            key = (n.op, canonical_attrs(stripped), rins)
            hash(key)
        except TypeError:
            continue
        keeper = seen.get(key)
        if keeper is None:
            seen[key] = n
            continue
        sub[id(n)] = keeper
        for i in range(n.num_outputs):
            entry_map[(id(n), i)] = (keeper, i)
        merged.append(f"{n.name}->{keeper.name}")
    details = {"merged": merged} if merged else {}
    return _substitute(symbol, entry_map), len(merged), "bitwise", details


# ---------------------------------------------------------------------------
# pallas_select
# ---------------------------------------------------------------------------

def _attention_flops(q_shape, k_shape, v_shape):
    """The reference's flop count of the unfused attention: XLA's cost
    analysis of ``softmax(Q·Kᵀ)·V``, which reads 2·(QKᵀ) + 2·(PV)
    multiply-adds, ``4·B·Lq·Lk·d``, plus the softmax's ``B·Lq·(4·Lk - 1)``
    (``v_shape``, the reference's third argument, adds nothing: V is
    [.., Lk, d])."""
    batch = 1
    for s in q_shape[:-2]:
        batch *= int(s)
    lq, d, lk = int(q_shape[-2]), int(q_shape[-1]), int(k_shape[-2])
    return 4.0 * batch * lq * lk * d + batch * lq * (4.0 * lk - 1.0)


def _match_attention(symbol, ctx, entry_shapes, counts, entry_map, details,
                     on_cuda):
    """batch_dot(softmax(batch_dot(Q, Kᵀ)[·s], axis=-1), V) →
    _fused_attention(Q, K, V, scale=s); the op takes rank 3 and 4 alike,
    so Q, K and V are rewired as they are."""
    min_flops = float(config.get_env("MXTPU_PALLAS_MIN_FLOPS", 1e6))
    swapped = 0
    for n in _topo(symbol._heads):
        if n.is_var or n.op != "batch_dot":
            continue
        a2 = _node_attrs(n)
        if a2.get_bool("transpose_a", False) or \
                a2.get_bool("transpose_b", False):
            continue
        sm, smi = n.inputs[0]
        if sm.is_var or sm.op != "softmax" or smi != 0 \
                or len(sm.inputs) != 1:
            continue
        sa = _node_attrs(sm)
        if sa.get_int("axis", -1) != -1:
            continue
        t = sa.get_attr("temperature", None)
        if t not in (None, "None") and float(t) != 1.0:
            continue
        if counts.get((id(sm), 0), 0) != 1:
            continue
        s_node, s_idx = sm.inputs[0]
        scale = 1.0
        if not s_node.is_var and s_node.op == "_mul_scalar" and s_idx == 0 \
                and counts.get((id(s_node), 0), 0) == 1:
            scale = _node_attrs(s_node).get_float("scalar", 0.0)
            s_node, s_idx = s_node.inputs[0]
        if s_node.is_var or s_node.op != "batch_dot" or s_idx != 0 \
                or counts.get((id(s_node), 0), 0) != 1:
            continue
        a1 = _node_attrs(s_node)
        if a1.get_bool("transpose_a", False) or \
                not a1.get_bool("transpose_b", False):
            continue
        q_e, k_e = s_node.inputs[0], s_node.inputs[1]
        v_e = n.inputs[1]

        def shp(e):
            node, idx = e
            return entry_shapes.get((id(node), idx))

        qs, ks, vs = shp(q_e), shp(k_e), shp(v_e)
        if qs is None or ks is None or vs is None:
            continue
        rank = len(qs)
        if rank not in (3, 4) or len(ks) != rank or len(vs) != rank:
            continue
        d = qs[-1]
        lk = ks[-2]
        if ks[-1] != d or vs[-2] != lk or vs[-1] != d:
            continue
        if qs[:-2] != ks[:-2] or qs[:-2] != vs[:-2]:
            continue
        # per-site fallback by the JAX package's rule only (ragged L)
        try:
            check_attention(qs, ks, vs)
        except ValueError as e:
            details.setdefault("fallback_sites", []).append(
                f"{n.name}: {e}")
            continue
        flops = _attention_flops(qs, ks, vs)
        if flops < min_flops:
            details.setdefault("below_threshold", []).append(
                f"{n.name}: {flops:.3g} < {min_flops:.3g}")
            continue
        if on_cuda:
            try:
                check_kernel_inputs(d, None)
            except ValueError as e:
                raise MXNetError(
                    f"pallas_select: attention site {n.name}: {e}; set "
                    "MXTPU_PALLAS=0 to serve this graph without the "
                    "kernel") from None
        fused = _Node("_fused_attention", ctx.name("attn"),
                      {"causal": False, "scale": float(scale)},
                      [q_e, k_e, v_e])
        entry_map[(id(n), 0)] = (fused, 0)
        swapped += 1
        details.setdefault("attention_sites", []).append(
            f"{n.name}: flops={flops:.3g} scale={scale}")
    return swapped


_MUL_OPS = frozenset({"broadcast_mul", "elemwise_mul", "_mul", "_Mul"})
_ADD_OPS = frozenset({"broadcast_add", "elemwise_add", "_add", "_plus",
                      "_Plus"})


def _match_lstm(symbol, ctx, entry_shapes, entry_dtypes, entry_map,
                details, on_cuda):
    """sigmoid/tanh LSTM gate math over one SliceChannel(gates, 4) →
    _fused_lstm_gates(gates, c_prev) (outputs: c_new, h_new), by the JAX
    package's rules: every matched site swaps (no flop floor), the gates
    must be rank 2 where their shape is known, and h = σ(o)·tanh(c_new)
    is rewired to output 1 where it is present."""

    def act_input(entry, kind):
        node, idx = entry
        if node.is_var or idx != 0:
            return None
        if node.op == kind:
            return node.inputs[0]
        if node.op == "Activation" and \
                _node_attrs(node).get_str("act_type", "relu") == kind:
            return node.inputs[0]
        return None

    def gate_slot(entry, kind):
        """entry is act(kind) over SliceChannel out k -> (slice_node, k)."""
        src = act_input(entry, kind)
        if src is None:
            return None
        s, k = src
        if s.is_var or s.op != "SliceChannel":
            return None
        sa = _node_attrs(s)
        if sa.get_int("num_outputs") != 4 or \
                sa.get_int("axis", 1) not in (1, -1) or \
                sa.get_bool("squeeze_axis", False):
            return None
        return (s, k)

    swapped = 0
    nodes = _topo(symbol._heads)
    for n in nodes:
        if n.is_var or n.op not in _ADD_OPS:
            continue
        l_e, r_e = n.inputs[0], n.inputs[1]
        if l_e[0].is_var or r_e[0].is_var:
            continue
        if l_e[0].op not in _MUL_OPS or r_e[0].op not in _MUL_OPS:
            continue
        found = None
        for f_mul, i_mul in ((l_e, r_e), (r_e, l_e)):
            fa, fb = f_mul[0].inputs[0], f_mul[0].inputs[1]
            ia, ib = i_mul[0].inputs[0], i_mul[0].inputs[1]
            for f_sig_e, c_prev_e in ((fa, fb), (fb, fa)):
                fslot = gate_slot(f_sig_e, "sigmoid")
                if fslot is None or fslot[1] != 1:
                    continue
                for i_sig_e, g_tanh_e in ((ia, ib), (ib, ia)):
                    islot = gate_slot(i_sig_e, "sigmoid")
                    gslot = gate_slot(g_tanh_e, "tanh")
                    if islot is None or gslot is None:
                        continue
                    if islot[1] != 0 or gslot[1] != 2:
                        continue
                    if islot[0] is not fslot[0] or gslot[0] is not fslot[0]:
                        continue
                    found = (fslot[0], c_prev_e)
                    break
                if found:
                    break
            if found:
                break
        if not found:
            continue
        slice_node, c_prev_e = found
        gates_e = slice_node.inputs[0]
        gkey, ckey = (id(gates_e[0]), gates_e[1]), (id(c_prev_e[0]),
                                                    c_prev_e[1])
        gs = entry_shapes.get(gkey)
        if gs is not None and len(gs) != 2:
            continue
        cs = entry_shapes.get(ckey)
        if on_cuda and gs is not None and cs is not None:
            try:
                check_lstm_kernel_inputs(
                    torch.empty(gs, dtype=entry_dtypes[gkey], device="meta"),
                    torch.empty(cs, dtype=entry_dtypes[ckey], device="meta"))
            except ValueError as e:
                raise MXNetError(
                    f"pallas_select: LSTM site {n.name}: {e}; set "
                    "MXTPU_PALLAS=0 to serve this graph without the "
                    "kernel") from None
        fused = _Node("_fused_lstm_gates", ctx.name("lstm"), {},
                      [gates_e, c_prev_e])
        entry_map[(id(n), 0)] = (fused, 0)   # c_new
        # h = o_sig * tanh(c_new): rewire when present
        for h in nodes:
            if h.is_var or h.op not in _MUL_OPS or (id(h), 0) in entry_map:
                continue
            for o_e, t_e in (tuple(h.inputs), tuple(reversed(h.inputs))):
                oslot = gate_slot(o_e, "sigmoid")
                if oslot is None or oslot[1] != 3 \
                        or oslot[0] is not slice_node:
                    continue
                t_src = act_input(t_e, "tanh")
                if t_src is not None and t_src[0] is n and t_src[1] == 0:
                    entry_map[(id(h), 0)] = (fused, 1)
                    break
        swapped += 1
        details.setdefault("lstm_sites", []).append(n.name)
    return swapped


def _pass_pallas_select(symbol, train, ctx, const_feed, shapes=None,
                        device=None, dtypes=None):
    """Swap matched attention subgraphs and LSTM cells for the Hopper
    kernels when the device gate (and, for attention, the flop floor) say
    so.  Parity is documented-ULP (the online softmax reassociates)."""
    mode = pallas_mode()
    if mode in ("0", "false", "off"):
        return symbol, 0, "ulp", {"skipped": "MXTPU_PALLAS=0"}
    on_cuda = device is not None and device.type == "cuda"
    if mode == "auto" and not (
            on_cuda and torch.cuda.get_device_capability(device) == (9, 0)):
        return symbol, 0, "ulp", {
            "skipped": f"MXTPU_PALLAS=auto and the bound device {device} is "
                       "not a CUDA device of capability (9, 0)"}
    entry_shapes, entry_dtypes = _infer_entries(symbol, shapes, dtypes)
    if not entry_shapes:
        return symbol, 0, "ulp", {"skipped": "no input shapes available "
                                             "for pattern matching"}
    entry_map: Dict[Tuple[int, int], Any] = {}
    details: Dict[str, Any] = {}
    n_attn = _match_attention(symbol, ctx, entry_shapes,
                              _consumer_counts(symbol), entry_map, details,
                              on_cuda)
    n_lstm = _match_lstm(symbol, ctx, entry_shapes, entry_dtypes, entry_map,
                         details, on_cuda)
    if not entry_map:
        return symbol, 0, "ulp", details
    details["note"] = ("kernel swap: parity within documented ULP "
                       "(online softmax reassociates; verified at "
                       "rtol/atol 2e-4 by tests)")
    return _substitute(symbol, entry_map), n_attn + n_lstm, "ulp", details


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

#: inference pipeline, in order
INFER_PASSES: Tuple[str, ...] = ("fold_const", "fold_bn", "eliminate",
                                 "cse", "pallas_select")
#: legacy training pipeline (``MXTPU_UNIFIED_STEP=0``)
TRAIN_PASSES: Tuple[str, ...] = ("cse", "dead_aux")
#: the training pipeline of the unified step
TRAIN_PASSES_UNIFIED: Tuple[str, ...] = ("eliminate", "cse", "dead_aux")


def train_passes() -> Tuple[str, ...]:
    """The training pass list in effect (``MXTPU_UNIFIED_STEP``, default
    on, selects the unified list, as in the JAX package)."""
    on = config.get_env("MXTPU_UNIFIED_STEP", "1").strip().lower() \
        not in ("0", "false", "off")
    return TRAIN_PASSES_UNIFIED if on else TRAIN_PASSES


_PASS_FNS: Dict[str, Callable] = {
    "fold_const": _pass_fold_const,
    "fold_bn": _pass_fold_bn,
    "eliminate": _pass_eliminate,
    "cse": _pass_cse,
    "dead_aux": _pass_dead_aux,
    "pallas_select": _pass_pallas_select,
}


def optimize(symbol, shapes: Optional[Dict] = None,
             device: Optional[torch.device] = None,
             train: bool = False,
             dtypes: Optional[Dict[str, torch.dtype]] = None
             ) -> PipelineResult:
    """Run the pass pipeline over ``symbol``: the inference list, or with
    ``train`` the training list.  ``shapes`` ({input name -> shape}) and
    ``dtypes`` ({input name -> dtype}, float32 where not given) feed the
    pattern matcher; ``device`` is where the graph will run, which the
    ``auto`` kernel gate reads.  The result's ``const_feed`` (CPU
    tensors) must be merged into every feed of the optimized graph."""
    if not graph_opt_enabled():
        return PipelineResult(symbol, {}, [], False)
    skip = skipped_passes()
    ctx = _Ctx(symbol)
    const_feed: Dict[str, torch.Tensor] = {}
    reports: List[PassReport] = []
    for name in (train_passes() if train else INFER_PASSES):
        if name in skip:
            continue
        before = _n_compute(symbol)
        t0 = time.perf_counter()
        extra = dict(shapes=shapes, device=device, dtypes=dtypes) \
            if name == "pallas_select" else {}
        symbol, rewrites, parity, details = _PASS_FNS[name](
            symbol, train, ctx, const_feed, **extra)
        wall_ms = (time.perf_counter() - t0) * 1e3
        reports.append(PassReport(name, before, _n_compute(symbol), rewrites,
                                  round(wall_ms, 3), parity, details))
        if rewrites:
            _prof.bump_graph(f"graph_opt/{name}_rewrites", rewrites)
    _prof.bump_graph("graph_opt/runs")
    if reports:
        removed = reports[0].nodes_before - reports[-1].nodes_after
        if removed > 0:
            _prof.bump_graph("graph_opt/nodes_removed", removed)
    return PipelineResult(symbol, const_feed, reports, True)


def _check_train_invariants(orig, opt) -> None:
    """What a training rewrite must keep: the output count, the number of
    nodes that draw random numbers, and the auxiliary state set."""
    if len(orig._heads) != len(opt._heads):
        raise MXNetError("graph_opt: training rewrite changed the output "
                         "count")

    def rng_count(sym):
        return sum(1 for n in _topo(sym._heads)
                   if not n.is_var and _reg.get_op(n.op).needs_rng)

    if rng_count(orig) != rng_count(opt):
        raise MXNetError("graph_opt: training rewrite changed the rng node "
                         "count")
    if orig._aux_var_names() != opt._aux_var_names():
        raise MXNetError("graph_opt: training rewrite changed the aux "
                         "state set")
    _prof.bump_graph("graph_opt/train_verifies")


def _verify_enabled() -> bool:
    return str(config.get_env("MXTPU_GRAPH_OPT_VERIFY", "0")).strip() \
        .lower() in ("1", "true", "on")


def verify_bitwise(orig, opt, feed, key, train: bool):
    """Run both graphs eagerly on ``feed`` with one random stream (a
    generator seeded with ``key``) and require identical outputs,
    identical auxiliary updates (each one the optimized graph still
    makes) and, for a training graph, identical gradients of every float
    input for ones as head gradients.  Raises MXNetError on a mismatch;
    returns True."""
    from .graph_compile import build_steps, run_plan
    device = next(iter(feed.values())).device
    floats = {n for n, v in feed.items() if v.is_floating_point()} \
        if train else set()

    def run(sym):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(key))
        leaves = {n: feed[n].detach().requires_grad_(True) for n in floats}
        with torch.enable_grad() if train else torch.no_grad():
            outs, aux = run_plan(build_steps(sym), {**feed, **leaves},
                                 train, gen)
            grads = {}
            live = [o for o in outs if o.requires_grad]
            if live:
                gs = torch.autograd.grad(
                    live, list(leaves.values()),
                    [torch.ones_like(o) for o in live], allow_unused=True)
                grads = {n: (torch.zeros_like(leaves[n]) if g is None
                             else g) for n, g in zip(leaves, gs)}
        return [o.detach() for o in outs], aux, grads

    o0, a0, g0 = run(orig)
    o1, a1, g1 = run(opt)
    for i, (x, y) in enumerate(zip(o0, o1)):
        if not torch.equal(x, y):
            raise MXNetError(f"graph_opt: bitwise verify failed on "
                             f"output {i}")
    for name, val in a1.items():
        if name not in a0 or not torch.equal(a0[name].detach(),
                                             val.detach()):
            raise MXNetError(f"graph_opt: bitwise verify failed on aux "
                             f"update {name!r}")
    for name in g0:
        if not torch.equal(g0[name], g1[name]):
            raise MXNetError(f"graph_opt: bitwise verify failed on "
                             f"gradient of {name!r}")
    return True


def training_result(symbol, verify_feed=None, verify_key=None):
    """`train_passes()` over a training graph: ``(symbol, reports)``, with
    the invariants checked whenever a pass rewrote the graph, and under
    ``MXTPU_GRAPH_OPT_VERIFY=1`` with a live feed the bitwise check of
    `verify_bitwise`; the reports are empty when the optimizer is
    disabled."""
    res = optimize(symbol, train=True)
    if not res.enabled or res.symbol is symbol:
        return symbol, list(res.reports)
    _check_train_invariants(symbol, res.symbol)
    if _verify_enabled() and verify_feed is not None \
            and verify_key is not None:
        verify_bitwise(symbol, res.symbol, verify_feed, verify_key,
                       train=True)
    return res.symbol, list(res.reports)


def training_symbol(symbol, verify_feed=None, verify_key=None):
    """`training_result`'s optimized symbol alone."""
    return training_result(symbol, verify_feed=verify_feed,
                           verify_key=verify_key)[0]
