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

from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .base import MXNetError, numpy_dtype
from .context import Context, default_context
from .ndarray.ndarray import NDArray, zeros
from .serialization import loads_ndarrays
from .symbol import symbol as _sym

__all__ = ["Predictor", "load_ndarray_bytes"]


def load_ndarray_bytes(blob: bytes):
    """Parse a `.params` blob from memory (reference `MXPredCreate`
    takes ``param_bytes``)."""
    return loads_ndarrays(blob)


class Predictor:
    """Forward-only model instance (reference `MXPredCreate` /
    `MXPredSetInput` / `MXPredForward` / `MXPredGetOutput` /
    `MXPredReshape`).

    ``params`` is a `.params` blob or its parsed form, a mapping of
    ``arg:``/``aux:``-prefixed or bare names to NDArrays (for example from
    `serialization.params_from_numpy`)."""

    def __init__(self, symbol_json: str,
                 params: Union[bytes, Mapping[str, NDArray]],
                 input_shapes: Dict[str, Tuple[int, ...]],
                 ctx: Optional[Context] = None):
        self._sym = _sym.load_json(symbol_json)
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
        self._bind(dict(input_shapes))

    def _bind(self, input_shapes: Dict[str, Tuple[int, ...]]):
        self._input_shapes = input_shapes
        arg_shapes, _, _ = self._sym.infer_shape(**input_shapes)
        args = {}
        for name, shape in zip(self._sym.list_arguments(), arg_shapes):
            if name in input_shapes:
                args[name] = zeros(shape, ctx=self._ctx)
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
