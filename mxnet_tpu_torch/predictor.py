"""Deploy-only inference API (the counterpart of `mxnet_tpu/predictor.py`;
reference `include/mxnet/c_predict_api.h`): load a symbol JSON and a
params blob, bind for input shapes, forward only.

A `Predictor` binds to ``cuda:0`` unless the caller passes ``ctx``; with
no CUDA device it raises rather than run on the CPU unasked.  It serves
through its executor's `GraphProgram`, so the graph optimizer's passes
apply, and on the card each forward replays the program's CUDA graph for
the bound shapes (a reshape binds, and captures, anew).  Every forward's
outputs are its own.  `export_compiled`/`load_compiled` come with the
serving slice.
"""
from __future__ import annotations

import struct
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .base import MXNetError, numpy_dtype
from .context import Context, default_context
from .ndarray.ndarray import NDArray, zeros
from .serialization import (CheckpointCorruptError, atomic_write,
                            dumps_ndarrays, loads_ndarrays, read_payload)
from .symbol import symbol as _sym

__all__ = ["Predictor", "load_ndarray_bytes", "CompiledBlobError",
           "ExportedModel"]


def load_ndarray_bytes(blob: bytes):
    """Parse a `.params` blob from memory (reference `MXPredCreate`
    takes ``param_bytes``)."""
    return loads_ndarrays(blob)


class CompiledBlobError(MXNetError):
    """An `export_compiled` deploy blob failed to parse: truncated,
    garbage, or not a compiled-model file of the port at all.  Structured
    (file + offset + detail) like serialization's CheckpointCorruptError,
    so deploy tooling can report where the artifact broke instead of
    surfacing a raw ``struct.error`` from the middle of a parse."""

    def __init__(self, file: str, offset: int, detail: str):
        self.file = file
        self.offset = int(offset)
        self.detail = detail
        super().__init__(
            f"corrupt compiled-model blob {file} at offset {offset}: "
            f"{detail}")


#: the port's blob magic; the JAX package's StableHLO blobs lead with
#: ``_JAX_MAGIC`` and are refused by name
_CB_MAGIC = b"MXTCBLB1"
_JAX_MAGIC = b"MXCBLOB1"


class _BlobReader:
    """Bounds-checked cursor over a compiled-model blob: every read names
    the file and offset on failure."""

    __slots__ = ("buf", "pos", "file")

    def __init__(self, buf: bytes, file: str):
        self.buf = buf
        self.pos = 0
        self.file = file

    def take(self, n: int, what: str) -> bytes:
        end = self.pos + n
        if n < 0 or end > len(self.buf):
            raise CompiledBlobError(
                self.file, self.pos,
                f"truncated: need {n} bytes for {what}, "
                f"{len(self.buf) - self.pos} remain")
        chunk = self.buf[self.pos:end]
        self.pos = end
        return chunk

    def u32(self, what: str) -> int:
        return struct.unpack("<I", self.take(4, what))[0]

    def i64(self, what: str) -> int:
        return struct.unpack("<q", self.take(8, what))[0]

    def u64(self, what: str) -> int:
        return struct.unpack("<Q", self.take(8, what))[0]


class ExportedModel:
    """A parsed `export_compiled` blob: the optimized inference graph
    (``symbol``), its weights by variable name (``params``, CPU
    tensors), and the inputs' names, numpy dtypes and shapes (``None``
    leading where the batch is dynamic, ``fixed_batch`` otherwise)."""

    def __init__(self, symbol, params: Dict[str, torch.Tensor],
                 input_names: List[str], input_dtypes: List[np.dtype],
                 in_shapes: List[Tuple], fixed_batch: Optional[int]):
        self.symbol = symbol
        self.params = params
        self.input_names = input_names
        self.input_dtypes = input_dtypes
        self.in_shapes = in_shapes
        self.fixed_batch = fixed_batch

    @property
    def trailing(self) -> Dict[str, Tuple[int, ...]]:
        return {n: tuple(s[1:]) for n, s in zip(self.input_names,
                                                self.in_shapes)}

    def weights_on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        return {n: t.to(device) for n, t in self.params.items()}


class Predictor:
    """Forward-only model instance (reference `MXPredCreate` /
    `MXPredSetInput` / `MXPredForward` / `MXPredGetOutput` /
    `MXPredReshape`).

    ``params`` is a `.params` blob or its parsed form, a mapping of
    ``arg:``/``aux:``-prefixed or bare names to NDArrays (for example from
    `serialization.params_from_numpy`).  ``output_names`` serves those
    outputs of the graph (`Symbol.list_outputs` names) instead of its
    heads; ``input_types`` gives inputs a dtype other than float32 (an
    int8 deploy graph's)."""

    def __init__(self, symbol_json: str,
                 params: Union[bytes, Mapping[str, NDArray]],
                 input_shapes: Dict[str, Tuple[int, ...]],
                 ctx: Optional[Context] = None,
                 output_names: Optional[Sequence[str]] = None,
                 input_types: Optional[Dict[str, object]] = None):
        self._sym = _sym.load_json(symbol_json)
        if output_names:
            self._sym = _sym.Group([self._sym[n] for n in output_names])
        self._ctx = ctx if ctx is not None else default_context("Predictor")
        if isinstance(params, (bytes, bytearray)):
            loaded = load_ndarray_bytes(params) if params else {}
        else:
            loaded = dict(params)
        if isinstance(loaded, list):
            raise MXNetError("params blob must carry names (arg:/aux:)")
        self._arg_params = {k[4:] if k.startswith("arg:") else k: v
                            for k, v in loaded.items()
                            if not k.startswith("aux:")}
        self._aux_params = {k[4:]: v for k, v in loaded.items()
                            if k.startswith("aux:")}
        self._inputs: Dict[str, object] = {}
        self._input_types = {n: np.dtype(t)
                             for n, t in (input_types or {}).items()}
        self._bind(dict(input_shapes))

    def _bind(self, input_shapes: Dict[str, Tuple[int, ...]]):
        self._input_shapes = input_shapes
        arg_shapes, _, _ = self._sym.infer_shape(**input_shapes)
        args = {}
        for name, shape in zip(self._sym.list_arguments(), arg_shapes):
            if name in input_shapes:
                args[name] = zeros(shape, ctx=self._ctx,
                                   dtype=self._input_types.get(name))
            elif name in self._arg_params:
                args[name] = self._arg_params[name]
            else:
                raise MXNetError(f"parameter {name!r} missing from params "
                                 "and not declared as an input")
        missing = set(self._sym.list_auxiliary_states()) - \
            set(self._aux_params)
        if missing:
            raise MXNetError(f"aux states {sorted(missing)} missing from "
                             "params")
        self._executor = self._sym.bind(self._ctx, args=args,
                                        aux_states=self._aux_params)
        # keep the device copies: a reshape rebinds without copying again
        self._arg_params.update(
            {n: a for n, a in self._executor.arg_dict.items()
             if n not in input_shapes})
        self._aux_params.update(self._executor.aux_dict)
        # the bind-time program: live forwards all run this one artifact
        self._program = self._executor.graph_program(train=False)
        self._outputs: Optional[List[NDArray]] = None

    def _validate_input(self, name: str, data) -> None:
        """Shape and dtype gate for one input, with a clear error here
        instead of a deep one from inside the forward."""
        if name not in self._input_shapes:
            raise MXNetError(f"{name!r} is not a declared input "
                             f"(declared: {sorted(self._input_shapes)})")
        want = tuple(self._input_shapes[name])
        got = tuple(data.shape) if hasattr(data, "shape") else \
            tuple(np.shape(data))
        if got != want:
            raise MXNetError(
                f"input {name!r}: shape {got} does not match the bound "
                f"shape {want}; use reshape({{{name!r}: {got}}}) to rebind "
                "for new input shapes")
        want_dt = numpy_dtype(self._executor.arg_dict[name].dtype)
        got_dt = data.dtype if hasattr(data, "dtype") else \
            np.asarray(data).dtype
        if isinstance(got_dt, torch.dtype):
            got_dt = numpy_dtype(got_dt)
        if not np.can_cast(got_dt, want_dt, casting="same_kind"):
            raise MXNetError(
                f"input {name!r}: dtype {np.dtype(got_dt).name} is not "
                f"same-kind castable to the bound dtype {want_dt.name}")

    # -- the c_predict_api surface ------------------------------------------
    def set_input(self, name: str, data) -> None:
        """`MXPredSetInput`."""
        self._validate_input(name, data)
        self._inputs[name] = data

    def forward(self, **inputs) -> None:
        """`MXPredForward` (inputs may also be passed here)."""
        for name, data in inputs.items():
            self._validate_input(name, data)
        self._inputs.update(inputs)
        missing = set(self._input_shapes) - set(self._inputs)
        if missing:
            raise MXNetError(f"inputs not set: {sorted(missing)}")
        self._outputs = self._executor.compiled_forward(is_train=False,
                                                        **self._inputs)

    def get_output(self, index: int = 0) -> NDArray:
        """`MXPredGetOutput`."""
        if self._outputs is None:
            raise MXNetError("call forward() first")
        return self._outputs[index]

    @property
    def num_outputs(self) -> int:
        return len(self._sym.list_outputs())

    def reshape(self, new_input_shapes: Dict[str, Tuple[int, ...]]):
        """`MXPredReshape`: rebind for new input shapes, keeping params."""
        shapes = dict(self._input_shapes)
        shapes.update(new_input_shapes)
        self._inputs.clear()
        self._bind(shapes)

    # -- the deploy blob ----------------------------------------------------
    def exported_model(self) -> ExportedModel:
        """This Predictor's bound inference program as an `ExportedModel`
        (its weights stay on the bound device): what `export_compiled`
        writes and what `serving.CompiledModelPool` serves."""
        names = sorted(self._input_shapes)
        program = self._program
        symbol = program._run_symbol
        wanted = set(symbol.list_arguments()) | \
            set(symbol.list_auxiliary_states())
        params: Dict[str, torch.Tensor] = {}
        for d in (self._executor.arg_dict, self._executor.aux_dict):
            for n, a in d.items():
                if n in wanted and n not in self._input_shapes:
                    params[n] = a.data
        for n, t in program.const_feed.items():
            if n in wanted:
                params[n] = t
        dtypes = [numpy_dtype(self._executor.arg_dict[n].dtype)
                  for n in names]
        shapes = [tuple(self._input_shapes[n]) for n in names]
        return ExportedModel(symbol, params, names, dtypes, shapes, None)

    def export_compiled(self, path: str, platforms=None,
                        dynamic_batch: bool = False) -> None:
        """Write the bound inference program as a deploy blob (see the
        module docstring) that reloads without this Predictor, the role
        `c_predict_api.cc` + amalgamation served.

        ``dynamic_batch=True`` records every input's leading dimension as
        the batch, so the serving pool captures the ONE blob at its whole
        batch ladder; otherwise the bound batch is baked in.
        ``platforms`` is accepted for the JAX package's signature: the
        blob runs on whatever device it is loaded onto.  The file is
        written crash-consistently with the serialization CRC footer."""
        model = self.exported_model()
        in_shapes = []
        for n, shape in zip(model.input_names, model.in_shapes):
            if dynamic_batch and not shape:
                raise MXNetError(
                    f"input {n!r} is a scalar: dynamic_batch export "
                    "requires a leading batch dimension on every input")
            in_shapes.append(((-1,) + shape[1:]) if dynamic_batch
                             else shape)
        params = dumps_ndarrays({"arg:" + n: NDArray(t)
                                 for n, t in model.params.items()})
        graph = model.symbol.tojson().encode("utf-8")
        header = bytearray(_CB_MAGIC)
        header += struct.pack("<I", len(model.input_names))
        for n, dt, shape in zip(model.input_names, model.input_dtypes,
                                in_shapes):
            raw = n.encode("utf-8")
            dts = np.dtype(dt).str.encode("ascii")
            header += struct.pack("<II", len(raw), len(dts))
            header += raw
            header += dts
            header += struct.pack("<I", len(shape))
            for d in shape:
                header += struct.pack("<q", int(d))
        payload = struct.pack("<Q", len(graph)) + graph + params
        header += struct.pack("<Q", len(payload))
        atomic_write(path, bytes(header) + payload, checksum=True)

    # sanity bounds on header fields: anything past these is garbage
    # bytes being misread as a header, not a real model
    _MAX_INPUTS = 4096
    _MAX_NAME_BYTES = 4096
    _MAX_DTYPE_BYTES = 64
    _MAX_NDIM = 32

    @staticmethod
    def load_exported(path: str):
        """Parse an `export_compiled` blob into its parts: returns
        ``(exported, input_names, input_dtypes)`` where ``exported`` is
        an `ExportedModel`.  The serving pool uses this form to capture
        the program at each ladder rung.

        Every parse step is bounds-checked; a truncated, bit-rotted,
        garbage or foreign file raises :class:`CompiledBlobError` naming
        the file and offset (never a raw ``struct.error`` or a silent
        misparse)."""
        try:
            payload = read_payload(path)  # verifies + strips CRC footer
        except CheckpointCorruptError as e:
            raise CompiledBlobError(
                path, e.offset, f"{e.kind} check failed: expected "
                f"{e.expected}, got {e.actual}") from e
        r = _BlobReader(payload, path)
        magic = payload[:len(_CB_MAGIC)]
        if magic == _JAX_MAGIC:
            raise CompiledBlobError(
                path, 0, f"magic {_JAX_MAGIC.decode()} is the JAX "
                "package's StableHLO blob, which the port cannot run; "
                "export the model from the port's Predictor (magic "
                f"{_CB_MAGIC.decode()})")
        if magic != _CB_MAGIC:
            raise CompiledBlobError(
                path, 0, f"no {_CB_MAGIC.decode()} magic (found "
                f"{bytes(magic)!r}): not a compiled-model blob")
        r.take(len(_CB_MAGIC), "format magic")
        n = r.u32("input count")
        if n > Predictor._MAX_INPUTS:
            raise CompiledBlobError(
                r.file, len(_CB_MAGIC),
                f"implausible input count {n} (max "
                f"{Predictor._MAX_INPUTS}): not a compiled-model blob")
        names, dtypes, shapes = [], [], []
        fixed = None
        for i in range(n):
            at = r.pos
            ln = r.u32(f"name length of input {i}")
            ld = r.u32(f"dtype length of input {i}")
            if ln > Predictor._MAX_NAME_BYTES or \
                    ld > Predictor._MAX_DTYPE_BYTES:
                raise CompiledBlobError(
                    r.file, at,
                    f"implausible header for input {i}: name {ln} bytes, "
                    f"dtype {ld} bytes")
            try:
                names.append(r.take(ln, f"name of input {i}")
                             .decode("utf-8"))
            except UnicodeDecodeError as e:
                raise CompiledBlobError(
                    r.file, at, f"input {i} name is not UTF-8") from e
            dt_at = r.pos
            dt_raw = r.take(ld, f"dtype of input {i}")
            try:
                dtypes.append(np.dtype(dt_raw.decode("ascii")))
            except (UnicodeDecodeError, TypeError) as e:
                raise CompiledBlobError(
                    r.file, dt_at,
                    f"input {i} dtype {dt_raw[:16]!r} is not a dtype "
                    "string") from e
            nd_at = r.pos
            ndim = r.u32(f"rank of input {i}")
            if ndim > Predictor._MAX_NDIM:
                raise CompiledBlobError(
                    r.file, nd_at, f"implausible rank {ndim} of input {i}")
            dims = [r.i64(f"dim {k} of input {i}") for k in range(ndim)]
            if any(d < 0 for d in dims[1:]) or (dims and dims[0] < -1):
                raise CompiledBlobError(
                    r.file, nd_at, f"input {i} has invalid dims {dims}")
            if dims and dims[0] >= 0 and fixed is None:
                fixed = dims[0]
            shapes.append(tuple(None if (k == 0 and d == -1) else d
                                for k, d in enumerate(dims)))
        at = r.pos
        blob_len = r.u64("payload length")
        remain = len(payload) - r.pos
        if remain != blob_len:
            raise CompiledBlobError(
                r.file, at,
                f"payload length mismatch: header says {blob_len} bytes, "
                f"file has {remain} (truncated or trailing garbage)")
        at = r.pos
        glen = r.u64("graph length")
        graph = r.take(glen, "graph JSON")
        try:
            symbol = _sym.load_json(graph.decode("utf-8"))
        except Exception as e:
            raise CompiledBlobError(r.file, at + 8,
                                    f"graph JSON rejected: {e}") from e
        at = r.pos
        try:
            loaded = loads_ndarrays(payload[at:], what=path)
        except MXNetError as e:
            raise CompiledBlobError(r.file, at,
                                    f"params payload rejected: {e}") from e
        if not isinstance(loaded, dict):
            raise CompiledBlobError(r.file, at, "params payload has no "
                                    "names")
        params = {k[4:] if k.startswith("arg:") else k: v.data
                  for k, v in loaded.items()}
        missing = (set(symbol.list_arguments())
                   | set(symbol.list_auxiliary_states())) \
            - set(params) - set(names)
        if missing:
            raise CompiledBlobError(r.file, at, f"graph variables "
                                    f"{sorted(missing)} have no weights")
        return (ExportedModel(symbol, params, names, dtypes, shapes, fixed),
                names, dtypes)

    @staticmethod
    def load_compiled(path: str, ctx: Optional[Context] = None):
        """Load an `export_compiled` blob; returns ``(call, input_names)``
        where ``call(**np_arrays)`` runs the program on ``ctx`` (by default
        ``cuda:0``; no CUDA device raises) and returns its outputs as
        numpy arrays.  On the card each batch size is captured once, at
        its first call, and replayed after."""
        from .graph_compile import StaticProgram, build_steps
        exported, names, dtypes = Predictor.load_exported(path)
        ctx = ctx if ctx is not None else default_context("load_compiled")
        device = ctx.device
        plan = build_steps(exported.symbol)
        weights = exported.weights_on(device)
        lock = threading.Lock()
        programs: Dict[Tuple, StaticProgram] = {}

        def call(**inputs):
            arrays = [np.asarray(inputs[k], dt)
                      for k, dt in zip(names, dtypes)]
            shapes = []
            for n, a, want in zip(names, arrays, exported.in_shapes):
                if a.ndim != len(want) or any(
                        w is not None and w != g
                        for w, g in zip(want, a.shape)):
                    raise MXNetError(
                        f"input {n!r}: shape {a.shape} does not match the "
                        f"exported {want} (None: any batch)")
                shapes.append(tuple(a.shape))
            key = tuple(shapes)
            with lock:
                prog = programs.get(key)
                if prog is None:
                    prog = programs[key] = StaticProgram(
                        plan, weights, list(zip(names, shapes, dtypes)),
                        device)
            return tuple(prog(arrays))

        return call, names
