"""Graph optimizer: rewrite passes over the bound Symbol graph (the
counterpart of `mxnet_tpu/graph_opt.py`).

Ported so far: **pallas_select**, which keeps the JAX package's pass name
so that the two packages' reports compare one to one.  It pattern-matches
two idioms and swaps in the ops of `ops/hopper_kernels.py`:

* MXNet's attention ``batch_dot(softmax(batch_dot(Q, Kᵀ)[·s]), V)`` →
  `_fused_attention` (K1), when the analytic flop count ``4·B·Lq·Lk·d``
  clears ``MXTPU_PALLAS_MIN_FLOPS``;
* the unfused LSTM cell of `rnn.LSTMCell` — ``SliceChannel(gates, 4)``,
  σ/σ/tanh/σ, ``f·c + i·g`` and ``o·tanh(c')`` → `_fused_lstm_gates` (K4),
  at every site, as in the JAX package.

Behind ``MXTPU_PALLAS``: ``auto`` swaps only when the bound device is CUDA
with compute capability (9, 0), ``1`` on any device, ``0`` never.  A site
keeps its unfused graph by the JAX package's rules alone (a ragged
sequence, see `hopper_kernels.check_attention`; gates not of rank 2).  On
CUDA a site the kernel is not built for (an attention head dim, an LSTM
dtype other than float32 or bfloat16) makes the bind fail:
``MXTPU_PALLAS=0`` is then the caller's choice, never a silent one.

The training pipeline (`optimize(..., train=True)`, `training_result`)
runs the JAX package's training pass list, which never holds
``pallas_select``: a training graph reaches the attention kernels only by
naming `_fused_attention` itself.  Its passes (``eliminate``, ``cse``,
``dead_aux``) are not ported yet and report 0 rewrites under their own
names; on the graphs the port trains the JAX package's make 0 rewrites
too.  The JAX package's other inference passes (fold_const, fold_bn,
eliminate, cse) wait for later slices.

Every pass is pure: the input symbol is never modified, and untouched
regions are shared by identity with the result.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import config
from .attribute import strip_annotations
from .base import MXNetError
from .ops import registry as _reg
from .ops.hopper_kernels import (check_attention, check_kernel_inputs,
                                 check_lstm_kernel_inputs)
from .ops.registry import Attrs
from .symbol.symbol import Symbol, _Node, _infer_graph, _topo, _value_key

__all__ = ["PassReport", "PipelineResult", "optimize", "graph_opt_enabled",
           "skipped_passes", "pallas_mode", "train_passes", "training_result",
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


@dataclass
class PipelineResult:
    """The optimized symbol and the per-pass reports."""
    symbol: Any
    reports: List[PassReport]
    enabled: bool


# ---------------------------------------------------------------------------
# rewrite machinery
# ---------------------------------------------------------------------------

def _n_compute(symbol) -> int:
    return sum(1 for n in _topo(symbol._heads) if not n.is_var)


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
# pallas_select
# ---------------------------------------------------------------------------

def _attention_flops(q_shape, k_shape):
    """2·(QKᵀ) + 2·(PV) multiply-adds: 4·B·Lq·Lk·d."""
    batch = 1
    for s in q_shape[:-2]:
        batch *= int(s)
    return 4.0 * batch * q_shape[-2] * k_shape[-2] * q_shape[-1]


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
        flops = _attention_flops(qs, ks)
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


def _pass_pallas_select(symbol, shapes, device, dtypes):
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
    ctx = _Ctx(symbol)
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
INFER_PASSES: Tuple[str, ...] = ("pallas_select",)
#: legacy training pipeline (the JAX package's pre-unification subset)
TRAIN_PASSES: Tuple[str, ...] = ("cse", "dead_aux")
#: the training pipeline of the JAX package's unified step
TRAIN_PASSES_UNIFIED: Tuple[str, ...] = ("eliminate", "cse", "dead_aux")


def train_passes() -> Tuple[str, ...]:
    """The training pass list in effect (``MXTPU_UNIFIED_STEP``, default
    on, selects the unified list, as in the JAX package)."""
    on = config.get_env("MXTPU_UNIFIED_STEP", "1").strip().lower() \
        not in ("0", "false", "off")
    return TRAIN_PASSES_UNIFIED if on else TRAIN_PASSES


def _pass_not_ported(symbol, shapes, device, dtypes):
    """A training pass of the JAX package that waits for a later slice:
    the graph passes through unchanged, reported under the pass's name."""
    return symbol, 0, "bitwise", {"skipped": "not ported yet"}


_PASS_FNS: Dict[str, Callable] = {
    "pallas_select": _pass_pallas_select,
    "eliminate": _pass_not_ported,
    "cse": _pass_not_ported,
    "dead_aux": _pass_not_ported,
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
    ``auto`` kernel gate reads."""
    if not graph_opt_enabled():
        return PipelineResult(symbol, [], False)
    skip = skipped_passes()
    reports: List[PassReport] = []
    for name in (train_passes() if train else INFER_PASSES):
        if name in skip:
            continue
        before = _n_compute(symbol)
        t0 = time.perf_counter()
        symbol, rewrites, parity, details = _PASS_FNS[name](symbol, shapes,
                                                            device, dtypes)
        wall_ms = (time.perf_counter() - t0) * 1e3
        reports.append(PassReport(name, before, _n_compute(symbol), rewrites,
                                  round(wall_ms, 3), parity, details))
    return PipelineResult(symbol, reports, True)


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


def training_result(symbol):
    """`train_passes()` over a training graph: ``(symbol, reports)``, with
    the invariants checked whenever a pass rewrote the graph; the reports
    are empty when the optimizer is disabled."""
    res = optimize(symbol, train=True)
    if not res.enabled or res.symbol is symbol:
        return symbol, list(res.reports)
    _check_train_invariants(symbol, res.symbol)
    return res.symbol, list(res.reports)
