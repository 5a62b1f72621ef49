"""Continuous-batching generation runtime: a fixed slot arena advancing
every active sequence one chunk of steps per replay (the counterpart of
`mxnet_tpu/generation.py`, with its classes, knobs, counters and blob).

The serving tier (`serving.py`, `serving_fleet.py`) batches fixed-shape
``infer`` requests; autoregressive generation breaks that model: a decode
run to completion as one dispatch lets one long sequence block every
short one, and batch occupancy collapses as sequences finish at different
steps.  This module keeps the whole decode loop inside one captured
program and makes admission and eviction a masked slot update at chunk
boundaries.

* :class:`DecodeCell` -- the per-step model: ``(params, state, token[K])
  -> (state', logits[K, V])`` batched over the K arena slots, its
  parameters on one device (``ctx``; by default the card).  Built from a
  Symbol cell by :meth:`DecodeCell.from_symbol` (lowered through
  `graph_compile.lower_step_fn`, which refuses host-crossing ops) or from
  a PyTorch callable.  Symbol cells serialize to decode blobs
  (:func:`save_decode_blob`, magic ``MXTPUDECODE1``, byte-compatible with
  the JAX package's) that the fleet registry verifies and replicas serve.

* :class:`DecodeEngine` -- owns the slot arena: K slots of recurrent
  state, prompt buffer, token cursors, output buffer and active mask,
  static tensors on the cell's device updated in place (the JAX package
  donates them).  One chunk program (``chunk_steps`` masked steps)
  advances every active slot; prompt tokens are teacher-forced inside it
  (prefill and generation are one program), and an eos hit or the slot's
  ``max_new_tokens`` budget flips its mask bit inside it too, so a
  finished sequence stops advancing at once and frees its slot at the
  next chunk boundary.  On a CUDA device the chunk is captured once as a
  CUDA graph and replayed per chunk, and admission (a slot-indexed write
  of the same buffers from a static staging row) is a second graph;
  elsewhere, or with ``MXTPU_GRAPH_COMPILE=0``, both run eagerly.  Each is
  built once, at its first use, which is its real run: ``traces`` (and
  the ``jit_traces`` step counter) counts those builds and stays flat
  under admission churn.  A chunk ends with one packed device-to-host
  copy of the mask, counts and outputs; nothing inside a chunk reads the
  host.

* :class:`DecodeService` -- the continuous-batching scheduler in front:
  a FIFO admission queue fills free slots at every chunk boundary, with
  the fleet's deadline and priority admission (estimated-wait refusal
  with an honest ``retry_after_ms``, low priority shed first, bounded
  queue).  ``MXTPU_GEN_CONTINUOUS=0`` runs static run-to-completion
  batches through the same chunk program.

Bitwise parity: the cell computes row-wise over the arena, so slot k's
outputs do not depend on the other slots; :meth:`DecodeEngine.
decode_sequential` (one sequence at a time through the same K-wide arena)
is the oracle.  ``torch.argmax`` returns the first maximum, as
``jnp.argmax`` does.

Observability: the profiler's ``gen`` family (admits, evictions, chunks,
TTFT p50/p99, tokens/s, occupancy, deadline refusals), and a chunk slower
than ``MXTPU_GEN_STALL_MS`` lands a ``decode_stall`` record in the
telemetry flight recorder.
"""
from __future__ import annotations

import contextlib
import struct
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import profiler as _prof
from . import ps_wire
from . import telemetry as _tele
from .base import MXNetError
from .config import get_env
from .context import Context, default_context
from .graph_compile import CapturedGraph, graph_compile_enabled, warm_up
from .serving import ServerDrainingError, ServerOverloadError

__all__ = ["DecodeCell", "DecodeEngine", "DecodeService",
           "save_decode_blob", "load_decode_blob", "is_decode_blob",
           "make_tanh_rnn_cell", "gen_continuous_enabled"]


def gen_continuous_enabled() -> bool:
    """The continuous-batching kill switch (``MXTPU_GEN_CONTINUOUS``,
    default on); 0 restores static run-to-completion batching through
    the same chunk program."""
    return str(get_env("MXTPU_GEN_CONTINUOUS")).strip().lower() \
        not in ("0", "false", "off")


def _device(ctx) -> torch.device:
    if ctx is None:
        ctx = default_context("DecodeCell")
    if isinstance(ctx, Context):
        return ctx.device
    return torch.device(ctx)


def _torch_dtype(dt) -> torch.dtype:
    return torch.from_numpy(np.zeros((), np.dtype(dt))).dtype


def _as_tensor(v, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(device)
    if hasattr(v, "asnumpy"):
        v = v.asnumpy()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v))).to(device)


# ---------------------------------------------------------------------------
# the decode cell
# ---------------------------------------------------------------------------

class DecodeCell:
    """One decode step batched over the arena: ``step_fn(params, state,
    token[K]) -> (state', logits[K, V])`` with ``state`` a dict of
    ``[K, ...]`` tensors.  ``state_specs`` maps each state name to its
    per-slot ``(trailing_shape, dtype)`` so the engine can allocate and
    zero slot rows without running the cell.  ``params`` (numpy arrays,
    tensors or NDArrays) move to ``ctx``'s device (by default the card;
    no CUDA device raises unless ``ctx`` names the CPU)."""

    def __init__(self, step_fn: Callable, params: Dict[str, Any],
                 state_specs: Dict[str, Tuple[Tuple[int, ...], Any]],
                 vocab_size: int, eos_id: Optional[int] = None,
                 symbol_json: Optional[str] = None,
                 token_name: str = "token",
                 state_order: Optional[Sequence[str]] = None,
                 ctx=None):
        self.device = _device(ctx)
        self.step_fn = step_fn
        self.params = {n: _as_tensor(v, self.device)
                       for n, v in params.items()}
        self.state_specs = {
            n: (tuple(shp), np.dtype(dt).name)
            for n, (shp, dt) in state_specs.items()}
        self.vocab_size = int(vocab_size)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.symbol_json = symbol_json
        self.token_name = str(token_name)
        self.state_order = list(state_order if state_order is not None
                                else self.state_specs)

    @classmethod
    def from_symbol(cls, symbol, params: Dict[str, Any],
                    state_specs: Dict[str, Tuple[Tuple[int, ...], Any]],
                    vocab_size: int, eos_id: Optional[int] = None,
                    token_name: str = "token",
                    state_order: Optional[Sequence[str]] = None,
                    ctx=None):
        """Lower a Symbol cell.  The symbol's variables are the token
        input (``token_name``, int32 ``[K]``), one variable per state
        name (``[K, ...]``) and the parameter variables; its heads are
        ``[logits] + [new_<state> for each state in order]``.  Lowering
        goes through `graph_compile.lower_step_fn`, so the whole cell
        runs inside the chunk program.  Decode is deterministic: an op
        that draws numbers draws from a fixed generator on the cell's
        device."""
        from .graph_compile import lower_step_fn
        order = list(state_order if state_order is not None
                     else state_specs)
        graph_fn = lower_step_fn(symbol, train=False)
        device = _device(ctx)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        tok_name = str(token_name)

        def step_fn(p, state, tok):
            feed = dict(p)
            feed[tok_name] = tok
            feed.update(state)
            outs, _aux = graph_fn(feed, gen)
            logits = outs[0]
            new_state = {name: outs[i + 1]
                         for i, name in enumerate(order)}
            return new_state, logits

        return cls(step_fn, params, state_specs, vocab_size,
                   eos_id=eos_id, symbol_json=symbol.tojson(),
                   token_name=tok_name, state_order=order, ctx=device)


def make_tanh_rnn_cell(vocab: int = 32, embed: int = 16,
                       hidden: int = 32, eos_id: Optional[int] = None,
                       seed: int = 0, ctx=None) -> DecodeCell:
    """A small greedy tanh-RNN decode cell (embed -> concat(x, h) ->
    FC+tanh -> FC logits) built as a Symbol, the JAX package's canonical
    test cell with the same weights for the same ``seed``; serializes to
    a decode blob."""
    from . import symbol as sym

    tok = sym.var("token")
    h = sym.var("h")
    x = sym.Embedding(tok, input_dim=vocab, output_dim=embed, name="emb")
    xh = sym.Concat(x, h, dim=1, name="xh")
    h_new = sym.Activation(
        sym.FullyConnected(xh, num_hidden=hidden, name="i2h"),
        act_type="tanh", name="hact")
    logits = sym.FullyConnected(h_new, num_hidden=vocab, name="h2o")
    cell_sym = sym.Group([logits, h_new])
    rng = np.random.RandomState(seed)
    params = {
        "emb_weight": rng.randn(vocab, embed).astype(np.float32) * 0.5,
        "i2h_weight": rng.randn(hidden, embed + hidden).astype(
            np.float32) * 0.3,
        "i2h_bias": np.zeros(hidden, np.float32),
        "h2o_weight": rng.randn(vocab, hidden).astype(np.float32) * 0.3,
        "h2o_bias": np.zeros(vocab, np.float32),
    }
    return DecodeCell.from_symbol(
        cell_sym, params, {"h": ((hidden,), np.float32)}, vocab,
        eos_id=eos_id, token_name="token", state_order=["h"], ctx=ctx)


# ---------------------------------------------------------------------------
# decode blobs (fleet registry artifacts)
# ---------------------------------------------------------------------------

DECODE_BLOB_MAGIC = b"MXTPUDECODE1\n"
_CRC = struct.Struct("<I")


def save_decode_blob(path: str, cell: DecodeCell) -> int:
    """Serialize a Symbol-backed decode cell to a registry-servable
    artifact: magic + body CRC + a zero-pickle wire-v2 encoded spec
    (symbol JSON, params, state specs, vocab/eos), the JAX package's
    layout.  Returns the whole-file CRC the registry records."""
    if cell.symbol_json is None:
        raise MXNetError(
            "save_decode_blob: only Symbol-backed cells serialize "
            "(build the cell with DecodeCell.from_symbol)")
    spec = {
        "format": "mxtpu-decode-blob",
        "version": 1,
        "symbol": cell.symbol_json,
        "token_name": cell.token_name,
        "state_order": list(cell.state_order),
        "state_specs": {n: [list(shp), dt]
                        for n, (shp, dt) in cell.state_specs.items()},
        "vocab_size": int(cell.vocab_size),
        "eos_id": -1 if cell.eos_id is None else int(cell.eos_id),
        "params": {n: v.detach().cpu().numpy()
                   for n, v in cell.params.items()},
    }
    body = ps_wire.encode(spec)
    blob = DECODE_BLOB_MAGIC + _CRC.pack(
        zlib.crc32(body) & 0xFFFFFFFF) + body
    with open(path, "wb") as f:
        f.write(blob)
    return zlib.crc32(blob) & 0xFFFFFFFF


def is_decode_blob(path: str) -> bool:
    """Sniff the artifact kind: decode blobs and `export_compiled` blobs
    share the registry, and ``register`` verifies each through its own
    loader."""
    try:
        with open(path, "rb") as f:
            head = f.read(len(DECODE_BLOB_MAGIC))
    except OSError:
        return False
    return head == DECODE_BLOB_MAGIC


def load_decode_blob(path: str, ctx=None) -> DecodeCell:
    """Load and verify a decode blob (magic, CRC, spec shape) onto
    ``ctx`` (by default the card); raises :class:`~mxnet_tpu_torch.
    predictor.CompiledBlobError` on rot so the registry's publish-time
    verification names the bad file."""
    from .predictor import CompiledBlobError
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(DECODE_BLOB_MAGIC):
        raise CompiledBlobError(path, 0, "not a decode blob (bad magic)")
    off = len(DECODE_BLOB_MAGIC)
    if len(raw) < off + _CRC.size:
        raise CompiledBlobError(path, len(raw), "truncated decode blob")
    (want_crc,) = _CRC.unpack_from(raw, off)
    body = raw[off + _CRC.size:]
    if (zlib.crc32(body) & 0xFFFFFFFF) != want_crc:
        raise CompiledBlobError(
            path, off, "decode blob body CRC mismatch (bit rot or "
            "truncation)")
    try:
        spec = ps_wire.decode(body)
    except Exception as e:
        raise CompiledBlobError(
            path, off + _CRC.size,
            f"undecodable decode blob body: {e}") from None
    if not isinstance(spec, dict) \
            or spec.get("format") != "mxtpu-decode-blob":
        raise CompiledBlobError(path, off + _CRC.size,
                                "decode blob spec malformed")
    from .symbol.symbol import load_json
    symbol = load_json(spec["symbol"])
    state_specs = {n: (tuple(shp), np.dtype(dt))
                   for n, (shp, dt) in spec["state_specs"].items()}
    eos = int(spec.get("eos_id", -1))
    return DecodeCell.from_symbol(
        symbol, dict(spec["params"]), state_specs,
        int(spec["vocab_size"]), eos_id=None if eos < 0 else eos,
        token_name=str(spec.get("token_name", "token")),
        state_order=list(spec["state_order"]), ctx=ctx)


# ---------------------------------------------------------------------------
# the slot arena
# ---------------------------------------------------------------------------

class _GenFuture:
    """Blocking handle for one generation request (the decode lane's
    analog of serving._InferFuture)."""

    def __init__(self, t_submit: float,
                 trace: Optional[str] = None):
        self.t_submit = float(t_submit)
        self.trace = trace
        self._ev = threading.Event()
        self._result: Optional[np.ndarray] = None
        self._exc: Optional[BaseException] = None
        self.ttft_ms: Optional[float] = None

    def set_result(self, tokens: np.ndarray) -> None:
        self._result = tokens
        self._ev.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._ev.wait(timeout):
            raise TimeoutError("generation result not ready")
        if self._exc is not None:
            raise self._exc
        return self._result


class _GenReq:
    """One admitted/queued request: padded prompt + budget + future."""

    __slots__ = ("prompt", "plen", "max_new", "priority", "deadline_ms",
                 "future", "slot", "chunks")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 priority: Optional[str], deadline_ms: Optional[float],
                 future: _GenFuture):
        self.prompt = prompt
        self.plen = int(prompt.shape[0])
        self.max_new = int(max_new)
        self.priority = priority
        self.deadline_ms = deadline_ms
        self.future = future
        self.slot: Optional[int] = None
        self.chunks = 0


class DecodeEngine:
    """The fixed slot arena and its two programs, each built once (chunk
    advance, slot admit).  Pure decode mechanics -- scheduling lives in
    :class:`DecodeService`; tests and the sequential-parity oracle drive
    the engine directly.  The arena lives on the cell's device."""

    def __init__(self, cell: DecodeCell, slots: Optional[int] = None,
                 chunk_steps: Optional[int] = None,
                 max_prompt: Optional[int] = None,
                 max_tokens: Optional[int] = None):
        self._cell = cell
        self.slots = int(slots if slots is not None
                         else get_env("MXTPU_GEN_SLOTS"))
        self.chunk_steps = int(chunk_steps if chunk_steps is not None
                               else get_env("MXTPU_GEN_CHUNK_STEPS"))
        self.max_prompt = int(max_prompt if max_prompt is not None
                              else get_env("MXTPU_GEN_MAX_PROMPT"))
        self.max_tokens = int(max_tokens if max_tokens is not None
                              else get_env("MXTPU_GEN_MAX_TOKENS"))
        if min(self.slots, self.chunk_steps, self.max_prompt,
               self.max_tokens) < 1:
            raise MXNetError("DecodeEngine: slots, chunk_steps, "
                             "max_prompt and max_tokens must be >= 1")
        self._eos = -1 if cell.eos_id is None else int(cell.eos_id)
        self.device = dev = cell.device
        K, P, G = self.slots, self.max_prompt, self.max_tokens
        i32 = torch.int32

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # the arena: static tensors every program updates in place
        self._arena = {
            "state": {n: zeros((K,) + tuple(shp), _torch_dtype(dt))
                      for n, (shp, dt) in cell.state_specs.items()},
            "prompt": zeros((K, P), i32),
            "plen": zeros((K,), i32),
            "pos": zeros((K,), i32),
            "last": zeros((K,), i32),
            "out": zeros((K, G), i32),
            "ngen": zeros((K,), i32),
            "maxgen": zeros((K,), i32),
            "active": zeros((K,), torch.bool),
        }
        self._cols = torch.arange(G, dtype=i32, device=dev)
        # what a chunk hands the host, in one copy: active | ngen | out
        self._view = zeros((K, 2 + G), i32)
        # admission's staging row: slot, plen, maxgen, padded prompt
        self._stage = zeros((3 + P,), i32)
        self._programs: Dict[str, Callable] = {}
        self._host: Optional[np.ndarray] = None
        self._reqs: List[Optional[_GenReq]] = [None] * K
        self.traces = 0           # programs built (captures on the card)
        self._stall_ms = float(get_env("MXTPU_GEN_STALL_MS"))
        self.last_chunk_s: Optional[float] = None
        _prof.set_gen_slots(0, K)

    # -- the two programs ------------------------------------------------

    def _one_step(self, params, arena) -> None:
        """One masked decode step over all K slots, written into the
        arena in place.  Teacher-forces prompt tokens while ``pos <
        plen`` (prefill), emits a generated token once the last prompt
        token has been consumed, and clears the slot's active bit on eos
        or budget exhaustion -- all on the device."""
        K, P, G = self.slots, self.max_prompt, self.max_tokens
        active = arena["active"]
        pos = arena["pos"]
        plen = arena["plen"]
        idx = pos.clamp(0, P - 1).long()
        prompt_tok = torch.gather(arena["prompt"], 1, idx[:, None])[:, 0]
        tok = torch.where(pos < plen, prompt_tok, arena["last"])
        new_state, logits = self._cell.step_fn(params, arena["state"],
                                               tok)
        produced = torch.argmax(logits, dim=-1).to(torch.int32)
        emit = active & (pos >= plen - 1)
        gpos = arena["ngen"].clamp(0, G - 1)
        col = self._cols[None, :] == gpos[:, None]
        out = torch.where(emit[:, None] & col, produced[:, None],
                          arena["out"])
        ngen = arena["ngen"] + emit.to(torch.int32)
        last = torch.where(emit, produced, arena["last"])
        eos_hit = emit & (produced == self._eos)
        still = active & ~(eos_hit | (ngen >= arena["maxgen"]))
        for name, new in new_state.items():
            old = arena["state"][name]
            keep = active.view((K,) + (1,) * (old.dim() - 1))
            old.copy_(torch.where(keep, new, old))
        arena["pos"].add_(active.to(torch.int32))
        arena["out"].copy_(out)
        arena["ngen"].copy_(ngen)
        arena["last"].copy_(last)
        arena["active"].copy_(still)

    def _chunk_fn(self) -> torch.Tensor:
        params, arena = self._cell.params, self._arena
        with torch.inference_mode():
            for _ in range(self.chunk_steps):
                self._one_step(params, arena)
            self._view[:, 0].copy_(arena["active"])
            self._view[:, 1].copy_(arena["ngen"])
            self._view[:, 2:].copy_(arena["out"])
        return self._view

    def _admit_fn(self) -> torch.Tensor:
        P = self.max_prompt
        arena, st = self._arena, self._stage
        with torch.inference_mode():
            slot = st[0:1].long()
            arena["prompt"].index_copy_(0, slot, st[3:].view(1, P))
            arena["plen"].index_copy_(0, slot, st[1:2])
            arena["maxgen"].index_copy_(0, slot, st[2:3])
            for name in ("pos", "last", "ngen", "out"):
                arena[name].index_fill_(0, slot, 0)
            arena["active"].index_fill_(0, slot, True)
            for t in arena["state"].values():
                t.index_fill_(0, slot, 0)
        return self._stage

    def _build(self, fn: Callable) -> Callable:
        """``fn`` as the program every later call runs: on a CUDA device
        its first run (the real one) warms it on a side stream and a CUDA
        graph is captured for the later calls; elsewhere every call runs
        ``fn``.  Counts one build."""
        _prof.bump_counter("jit_traces")
        self.traces += 1
        if self.device.type == "cuda" and graph_compile_enabled():
            warm_up(fn, self.device)
            return CapturedGraph(fn, self.device).replay
        fn()
        return fn

    def _run(self, which: str) -> None:
        """Run the chunk or the admit program, building it at its first
        call."""
        fn = self._chunk_fn if which == "chunk" else self._admit_fn
        on_card = torch.cuda.device(self.device) \
            if self.device.type == "cuda" else contextlib.nullcontext()
        with on_card:
            run = self._programs.get(which)
            if run is None:
                self._programs[which] = self._build(fn)
            else:
                run()

    # -- slot bookkeeping ------------------------------------------------

    def free_slots(self) -> List[int]:
        return [k for k, r in enumerate(self._reqs) if r is None]

    @property
    def slots_active(self) -> int:
        return sum(1 for r in self._reqs if r is not None)

    def validate(self, prompt: np.ndarray, max_new: int) -> np.ndarray:
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise MXNetError("generate: prompt must hold >= 1 token")
        if prompt.shape[0] > self.max_prompt:
            raise MXNetError(
                f"generate: prompt length {prompt.shape[0]} exceeds the "
                f"arena's MXTPU_GEN_MAX_PROMPT={self.max_prompt}")
        if not 1 <= int(max_new) <= self.max_tokens:
            raise MXNetError(
                f"generate: max_new_tokens {max_new} outside "
                f"[1, MXTPU_GEN_MAX_TOKENS={self.max_tokens}]")
        return prompt

    def admit(self, req: _GenReq) -> int:
        """Install one request into a free slot: its row is staged on the
        device and one run of the admit program (a graph replay on the
        card) writes it into the arena -- the slot index is data, so no
        new program is built."""
        free = self.free_slots()
        if not free:
            raise MXNetError("DecodeEngine.admit: no free slot")
        k = free[0]
        row = np.zeros((3 + self.max_prompt,), np.int32)
        row[0], row[1], row[2] = k, req.plen, req.max_new
        row[3:3 + req.plen] = req.prompt
        self._stage.copy_(torch.from_numpy(row))
        self._run("admit")
        req.slot = k
        self._reqs[k] = req
        _prof.bump_gen("admits")
        _prof.set_gen_slots(self.slots_active, self.slots)
        return k

    def step_chunk(self) -> float:
        """Advance every active slot by one chunk (one run of the chunk
        program: a CUDA graph replay on the card) and copy its packed
        mask, counts and outputs to the host; returns the wall time.  A
        chunk exceeding ``MXTPU_GEN_STALL_MS`` lands a ``decode_stall``
        record in the flight recorder."""
        t0 = time.monotonic()
        self._run("chunk")
        # the one device-to-host copy of the chunk; it waits for the
        # chunk, so the wall time covers its execution
        self._host = self._view.to("cpu").numpy() \
            if self._view.is_cuda else self._view.numpy().copy()
        dt = time.monotonic() - t0
        self.last_chunk_s = dt
        for r in self._reqs:
            if r is not None:
                r.chunks += 1
        _prof.bump_gen_many({"chunks": 1,
                             "steps": self.chunk_steps})
        if self._stall_ms > 0 and dt * 1e3 > self._stall_ms:
            _tele.record_error(
                f"decode chunk stalled: {dt * 1e3:.0f}ms for "
                f"{self.chunk_steps} steps "
                f"(MXTPU_GEN_STALL_MS={self._stall_ms:.0f})",
                kind="decode_stall", chunk_ms=float(dt * 1e3),
                chunk_steps=int(self.chunk_steps),
                slots_active=int(self.slots_active))
        return dt

    def harvest(self, now: Optional[float] = None
                ) -> List[Tuple[_GenReq, np.ndarray]]:
        """Collect finished sequences (mask bit already cleared on the
        device) from the last chunk's host copy, free their slots, record
        TTFT for slots that emitted their first token, and return
        ``[(request, tokens)]``."""
        now = time.monotonic() if now is None else now
        if self._host is None:
            return []
        active = self._host[:, 0]
        ngen = self._host[:, 1]
        out = self._host[:, 2:]
        finished: List[Tuple[_GenReq, np.ndarray]] = []
        new_tokens = 0
        for k, req in enumerate(self._reqs):
            if req is None:
                continue
            if req.future.ttft_ms is None and ngen[k] > 0:
                ttft = max(0.0, now - req.future.t_submit)
                req.future.ttft_ms = ttft * 1e3
                _prof.observe_gen_ttft(ttft, now=now)
            if not active[k]:
                toks = out[k, :int(ngen[k])].copy()
                new_tokens += int(ngen[k])
                finished.append((req, toks))
                self._reqs[k] = None
        if finished:
            _prof.bump_gen("evictions", len(finished))
            _prof.observe_gen_tokens(new_tokens, now=now)
            _prof.set_gen_slots(self.slots_active, self.slots)
        return finished

    def fail_all(self, exc: BaseException) -> None:
        """Engine shutdown: every in-flight slot's caller gets the
        structured error (never silently dropped)."""
        for k, req in enumerate(self._reqs):
            if req is not None:
                req.future.set_exception(exc)
                self._reqs[k] = None
        _prof.set_gen_slots(0, self.slots)

    # -- direct decode (bench + parity oracle) ---------------------------

    def decode(self, prompts: Sequence[np.ndarray],
               max_new: Sequence[int]) -> List[np.ndarray]:
        """Continuous-batched direct decode: fill free slots, chunk,
        harvest, repeat.  In-process convenience for tests and benches;
        serving traffic goes through :class:`DecodeService`."""
        pending = deque(
            _GenReq(self.validate(p, m), int(m), None, None,
                    _GenFuture(time.monotonic()))
            for p, m in zip(prompts, max_new))
        order = list(pending)
        while pending or self.slots_active:
            while pending and self.free_slots():
                self.admit(pending.popleft())
            self.step_chunk()
            for req, toks in self.harvest():
                req.future.set_result(toks)
        return [r.future.result(0) for r in order]

    def decode_sequential(self, prompts: Sequence[np.ndarray],
                          max_new: Sequence[int]) -> List[np.ndarray]:
        """The bitwise-parity oracle: one sequence at a time through the
        same K-wide arena and the same chunk program."""
        outs = []
        for p, m in zip(prompts, max_new):
            outs.extend(self.decode([p], [m]))
        return outs


# ---------------------------------------------------------------------------
# the continuous-batching scheduler
# ---------------------------------------------------------------------------

class DecodeService:
    """FIFO admission queue + pump thread over a :class:`DecodeEngine`.

    Admission follows the fleet's contract: a bounded queue sheds with
    :class:`ServerOverloadError` carrying an honest ``retry_after_ms``
    (the estimated queue wait), a request whose ``deadline_ms`` budget the
    estimated wait already exceeds is refused immediately (never queued
    to die), and when the queue is full a queued low-priority request is
    shed first to make room for normal traffic.  ``continuous=False`` (or
    ``MXTPU_GEN_CONTINUOUS=0``) switches to static run-to-completion
    batching: slots only refill once the whole arena drains.

    Pure-logic testability: construct with ``start=False`` and an
    injectable ``clock`` and drive :meth:`pump_once` by hand."""

    def __init__(self, engine: DecodeEngine,
                 continuous: Optional[bool] = None,
                 queue_limit: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 chunk_ms_hint: Optional[float] = None,
                 start: bool = True):
        self._engine = engine
        self.continuous = bool(gen_continuous_enabled()
                               if continuous is None else continuous)
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else get_env("MXTPU_GEN_QUEUE_LIMIT"))
        self._clock = clock if clock is not None else time.monotonic
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._running = True
        # coarse wait model for deadline admission + the retry hint:
        # EMA of chunk wall time and of chunks-per-completed-sequence
        self._chunk_ms_ema = chunk_ms_hint
        self._chunks_per_seq_ema = 1.0
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._pump_loop, name="mxtpu-gen-pump",
                daemon=True)
            self._thread.start()

    # -- admission -------------------------------------------------------

    def estimated_wait_ms(self) -> float:
        """Honest-but-coarse queueing delay estimate for a NEW request:
        queue position ahead of it, worked off ``slots`` sequences per
        ``chunks_per_seq`` chunks at the observed chunk time."""
        chunk_ms = self._chunk_ms_ema
        if chunk_ms is None:
            # never dispatched: assume 1ms/step, still bounded below
            chunk_ms = float(self._engine.chunk_steps)
        with self._cond:
            ahead = len(self._queue)
        active = self._engine.slots_active
        waves = (ahead + active) / max(1, self._engine.slots)
        return max(1.0, chunk_ms * self._chunks_per_seq_ema * waves)

    def submit(self, prompt, max_new_tokens: int,
               priority: Optional[str] = None,
               deadline_ms: Optional[float] = None) -> _GenFuture:
        """Admit one generation request; returns a future.  Sheds are
        structured and immediate: deadline refusal, queue-full refusal
        (low-priority first), draining refusal -- never a silent queue
        death."""
        _prof.bump_gen("requests")
        prompt = self._engine.validate(prompt, max_new_tokens)
        fut = _GenFuture(self._clock(), trace=_tele.current_trace())
        req = _GenReq(prompt, int(max_new_tokens), priority,
                      deadline_ms, fut)
        est = self.estimated_wait_ms()
        if deadline_ms is not None and est > float(deadline_ms):
            _prof.bump_gen("deadline_refusals")
            exc = ServerOverloadError(
                1, len(self._queue), self.queue_limit,
                retry_after_ms=min(10_000.0, est))
            _tele.record_error(exc, kind="gen_deadline_refusal",
                               estimated_wait_ms=float(est),
                               deadline_ms=float(deadline_ms))
            raise exc
        with self._cond:
            if not self._running:
                raise ServerDrainingError(1, len(self._queue),
                                          closed=True)
            if len(self._queue) >= self.queue_limit:
                victim = None
                if (priority or "") != "low":
                    # shed the youngest queued low-priority request to
                    # admit normal traffic (low sheds first)
                    for i in range(len(self._queue) - 1, -1, -1):
                        if self._queue[i].priority == "low":
                            victim = self._queue[i]
                            del self._queue[i]
                            break
                if victim is None:
                    _prof.bump_gen("sheds")
                    raise ServerOverloadError(
                        1, len(self._queue), self.queue_limit,
                        retry_after_ms=min(10_000.0, est))
                _prof.bump_gen("priority_sheds")
                victim.future.set_exception(ServerOverloadError(
                    1, len(self._queue), self.queue_limit,
                    retry_after_ms=min(10_000.0, est)))
            self._queue.append(req)
            self._cond.notify()
        return fut

    @property
    def queue_len(self) -> int:
        with self._cond:
            return len(self._queue)

    def stats(self) -> Dict[str, Any]:
        eng = self._engine
        active, total = eng.slots_active, eng.slots
        return {
            "gen_queue": int(self.queue_len),
            "gen_slots_active": int(active),
            "gen_slots": int(total),
            "gen_occupancy": float(active) / total if total else 0.0,
            "gen_est_wait_ms": float(self.estimated_wait_ms()),
            "gen_continuous": bool(self.continuous),
        }

    # -- the pump --------------------------------------------------------

    def _fill_slots(self) -> int:
        """Admit queued requests into free slots.  Continuous mode
        refills at every chunk boundary; static mode only refills a
        fully drained arena (run-to-completion batching)."""
        admitted = 0
        if not self.continuous and self._engine.slots_active > 0:
            return 0
        while True:
            with self._cond:
                if not self._queue or not self._engine.free_slots():
                    break
                req = self._queue.popleft()
            self._engine.admit(req)
            admitted += 1
        return admitted

    def _note_chunk(self, dt_s: float) -> None:
        ms = dt_s * 1e3
        self._chunk_ms_ema = ms if self._chunk_ms_ema is None else \
            0.8 * self._chunk_ms_ema + 0.2 * ms

    def _note_finished(self, req: _GenReq) -> None:
        self._chunks_per_seq_ema = (0.8 * self._chunks_per_seq_ema
                                    + 0.2 * max(1, req.chunks))

    def pump_once(self) -> int:
        """One scheduler cycle: fill free slots, advance one chunk,
        harvest.  Returns the number of sequences finished.  Public so
        fake-clock tests drive the whole scheduler deterministically."""
        self._fill_slots()
        if self._engine.slots_active == 0:
            return 0
        self._note_chunk(self._engine.step_chunk())
        finished = self._engine.harvest(now=self._clock())
        for req, toks in finished:
            self._note_finished(req)
            req.future.set_result(toks)
        if finished:
            self._fill_slots()
        return len(finished)

    def _pump_loop(self) -> None:
        if self._engine.device.type == "cuda":
            torch.cuda.set_device(self._engine.device)
        while True:
            with self._cond:
                while (self._running and not self._queue
                       and self._engine.slots_active == 0):
                    self._cond.wait(timeout=0.2)
                if not self._running:
                    return
            try:
                self.pump_once()
            except Exception as e:      # pragma: no cover - last resort
                _tele.record_error(e, kind="decode_stall",
                                   where="pump_loop")
                self._engine.fail_all(e)
                with self._cond:
                    while self._queue:
                        self._queue.popleft().future.set_exception(e)

    def close(self) -> None:
        with self._cond:
            if not self._running:
                return
            self._running = False
            queued = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        exc = ServerDrainingError(1, 0, closed=True)
        for req in queued:
            req.future.set_exception(exc)
        self._engine.fail_all(MXNetError("decode service closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
