"""mxnet_tpu_torch — the PyTorch/CUDA port of `mxnet_tpu` for NVIDIA
Hopper.

Same user surface and file formats as the JAX package (op names and
attrs, Symbol JSON, `.params` blobs); plain tensor code is PyTorch and the
JAX package's Pallas kernels are rewritten by hand for Hopper
(`ops/hopper_kernels.py`, sources in `csrc/`).  It never imports JAX or
the JAX package.

Ported so far: the deploy path ``Predictor(symbol_json, params,
input_shapes)`` over the ops a BERT encoder and an unrolled LSTM language
model use, with the graph optimizer's five inference passes (constant
and BatchNorm folding, elimination, CSE, and the swaps onto the
flash-attention forward kernel and the fused LSTM cell-update kernel);
the legacy symbolic RNN package (`rnn`: every cell, the fused ``RNN``
op's `rnn.FusedRNNCell`, its checkpoints and `rnn.BucketSentenceIter`);
symbolic training through ``mod.Module`` and ``mod.BucketingModule``
(bind, init_params, init_optimizer, forward, backward, update, and
``fit``/``score``/``predict`` with `metric`, `lr_scheduler` and
`callback`) with SGD and Adam, where attention's gradient runs on the
flash-attention backward kernels, and its checkpoints (`model`); and the
imperative path: an NDArray with arithmetic, slicing and gradients,
`autograd` (record, backward, grad, Function) over torch's autograd, and
`gluon` (Parameter, Block and HybridBlock with ``hybridize``, the `nn`
layers, the recurrent cells and layers of `gluon.rnn`, the losses,
`Trainer`, `data`, `utils` and the vision families of
`model_zoo.vision`); the training state and sparse storage: CSR and
row-sparse NDArrays (`nd.sparse`, `sym.sparse`) with their `.params`
form, `io.LibSVMIter`, the local `kvstore` with 2-bit compression,
`monitor.Monitor`, and crash-consistent `checkpoint`s with `fit`'s
``MXTPU_CKPT_DIR`` auto-resume; the op surface of the JAX package's
elementwise, broadcast/reduce, matrix, linear-algebra, random and nn
files (`nd.random`, `nd.linalg`, their `sym` forms, `mx.rnd`), the fluent
methods of NDArray and Symbol, `nd.save`/`nd.load`, ``with ctx:`` scopes
(`current_context`), `name`, `AttrScope` and `visualization`; every
optimizer and initializer of the JAX package; and the data plane:
`recordio`, the native host library (`io_native`), `image` (`img`) with
its detection pipeline, the image iterators of `io` staging uint8
batches to the card through pinned buffers, and the `engine` that runs
`io.PrefetchingIter`'s fetches; observability (`profiler` over
`torch.profiler` with the counter families, `telemetry`, `log`,
`test_utils`, `analysis`) and the one-server serving plane
(`Predictor.export_compiled`, `ps_wire`, `serving.CompiledModelPool` with
one CUDA graph per ladder rung, `ModelServer`, `ServeClient`) and the rest
of it: `generation` (the continuous-batching slot arena, its chunk one
CUDA graph), `serving_fleet` (`Router`, `ModelRegistry`,
`ReplicaSupervisor`, replica processes), `autoscale` and
`fault_injection`; several contexts in one process: `executor_manager`,
Module and `gluon.Trainer` over context lists, and ``group2ctx`` model
parallelism.  On the card, inference
forwards, hybridized predict-mode forwards and Module's whole training
step run as CUDA graphs.
"""
from . import base, config, ops  # noqa: F401
from .base import MXNetError
from .context import (Context, cpu, cpu_pinned, cpu_shared,
                      current_context, gpu, num_gpus)
from . import ndarray as nd
from . import symbol as sym
from . import random, io, initializer, optimizer, rnn  # noqa: F401
from . import lr_scheduler, metric, callback, model  # noqa: F401
from . import initializer as init
from . import module as mod
from .predictor import Predictor
from . import autograd, gluon  # noqa: E402
from . import kvstore, monitor, checkpoint  # noqa: E402
from . import kvstore as kv  # noqa: E402
from . import monitor as mon  # noqa: E402
from .monitor import Monitor  # noqa: E402
from . import random as rnd  # noqa: E402
from . import engine, recordio, image  # noqa: E402
from . import image as img  # noqa: E402
from . import name, attribute, visualization  # noqa: E402
from . import visualization as viz  # noqa: E402
from .attribute import AttrScope  # noqa: E402
from .ndarray import NDArray  # noqa: E402
from .executor import Executor  # noqa: E402
from . import operator, subgraph  # noqa: E402
from . import log, profiler, telemetry, test_utils  # noqa: E402
from . import predictor, ps_wire, serving  # noqa: E402
from . import fault_injection, generation  # noqa: E402
from . import serving_fleet, autoscale  # noqa: E402
from . import executor_manager  # noqa: E402

__all__ = ["MXNetError", "Context", "cpu", "gpu", "cpu_pinned",
           "cpu_shared", "current_context", "num_gpus", "nd", "sym",
           "random", "rnd", "name", "attribute", "AttrScope",
           "visualization", "viz", "NDArray", "Executor",
           "io", "init", "initializer", "optimizer", "mod", "rnn",
           "lr_scheduler", "metric", "callback", "model", "Predictor",
           "autograd", "gluon", "kvstore", "kv", "monitor", "mon", "Monitor",
           "checkpoint", "engine", "recordio", "image", "img", "operator",
           "subgraph", "log", "profiler", "telemetry", "test_utils",
           "predictor", "ps_wire", "serving", "fault_injection",
           "generation", "serving_fleet", "autoscale", "executor_manager"]
