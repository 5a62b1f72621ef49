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
parallelism; and the parameter-server plane: the ``dist`` stores of
`kvstore` over a `torch.distributed` group (`parallel.distributed`,
formed from the launcher's ``DMLC_*`` env), the fork's asynchronous
`ps_server` (``BYTEPS_ENABLE_ASYNC``; under ``DMLC_ROLE=server`` importing
the package serves it, `kvstore_server`), the bucketed, overlapped
`comm_plane` and the row-sharded `embedding_plane`; and the front end:
`gluon.contrib`, `contrib` (text, SVRG, ONNX, TensorBoard, TensorRT's
flags), `registry`, `resource`, `runtime`, `rtc` (CUDA source compiled
by NVRTC at run time), the torch `plugin` (``mx.th``), `notebook`,
`libinfo`, `misc`, `util` and the doc builders.  On the card, inference
forwards, hybridized predict-mode forwards and Module's whole training
step run as CUDA graphs.
"""
from . import base, config, registry, ops  # noqa: F401
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
from . import parallel, ps_server, comm_plane  # noqa: E402
from . import embedding_plane  # noqa: E402
from . import contrib  # noqa: E402
from . import libinfo, misc, util, ndarray_doc, symbol_doc  # noqa: E402
from . import notebook, runtime, rtc, resource  # noqa: E402
from . import plugin, torch  # noqa: E402
from . import torch as th  # noqa: E402

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
           "generation", "serving_fleet", "autoscale", "executor_manager",
           "parallel", "ps_server", "comm_plane", "embedding_plane",
           "kvstore_server", "contrib", "registry", "libinfo", "misc",
           "util", "ndarray_doc", "symbol_doc", "notebook", "runtime", "rtc",
           "resource", "plugin", "torch", "th"]

# imported last, as the reference's (`python/mxnet/__init__.py:91`): under
# DMLC_ROLE=server with BYTEPS_ENABLE_ASYNC set, this process becomes the
# asynchronous parameter server here
from . import kvstore_server  # noqa: E402
