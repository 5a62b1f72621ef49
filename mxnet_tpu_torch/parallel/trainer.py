"""SPMDTrainer: a Gluon block's training step over a mesh of ranks (the
counterpart of `mxnet_tpu/parallel/trainer.py`).

The JAX package compiles forward, loss, backward, the gradient reduction
and the optimizer into one GSPMD program.  Here each rank runs that step
on its block of the batch:

* **dp.**  The batch is split over dp.  A rank's loss is its rows' sum
  over the global row count, so the gradients summed over dp (in rank
  order, the same bits on every rank) are those of the global mean.
  BatchNorm takes its moments over the whole batch (`ops.nn.
  batch_stats_scope`, a ``psum`` over dp in the forward and its
  transpose in the backward), so the step is one device's on the whole
  batch.
* **tp.**  A weight the parameter rule splits over tp is kept, with its
  optimizer state, as this rank's block; the step gathers it for the
  forward and updates only the block, from the block of the gradient.
* Other axes (pp, sp, ep) replicate the step, as they do in the JAX
  package's default rule.  With ``seq_axis`` the data's sequence dim is
  split over sp too, and the reductions run over dp and sp.

``compute_dtype='bfloat16'`` runs forward and backward in bf16 with fp32
master weights, gradients as applied and optimizer state; ``'float16'``
adds the dynamic loss scale (an overflow step is skipped and halves the
scale, ``scale_window`` clean steps double it), whose finite check reads
the host once a step.

On a card, over a mesh of one rank (no collective in the step), a step
is captured as one CUDA graph per input shape set and replayed, as the
unified step is: the batch is copied into static buffers, the weights,
optimizer states and aux states are updated in place, and lr, wd and the
step count come from a device buffer written before each replay.  The
first step of a shape set runs eagerly on a side stream (the warm-up, a
real step), then the capture.  Over several ranks, whose collectives
stage through the host, under fp16's loss scale (a host read a step) and
with ``MXTPU_GRAPH_COMPILE=0`` the step runs eagerly.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import autograd
from ..ndarray.ndarray import NDArray
from ..ops.nn import batch_stats_scope
from . import collectives as C
from .functional import functionalize, split_params
from .mesh import DP, SP, Mesh, auto_mesh, mesh_scope
from .optim import pure_rule
from .sharding import (NamedSharding, ShardedTensor, batch_pspec,
                       default_param_rule, global_put)

__all__ = ["SPMDTrainer"]

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


def _torch_dtype(dt):
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    return _DTYPES[np.dtype(dt).name if not isinstance(dt, str) else dt]


class SPMDTrainer:
    """Train a Gluon block over a mesh.  Parameters must be initialized
    (run one forward) before construction.  ``loss_fn(outputs, labels)``
    returns the per-sample loss (any gluon.loss block).  ``donate`` is
    accepted for the JAX package's signature: the step updates its
    buffers in place either way."""

    def __init__(self, block, optimizer, loss_fn: Callable,
                 mesh: Optional[Mesh] = None,
                 param_rule: Optional[Callable] = None,
                 seq_axis: Optional[int] = None,
                 donate: bool = True,
                 compute_dtype=None):
        from .. import optimizer as opt_mod
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer)
        self.compute_dtype = _torch_dtype(compute_dtype)
        self._dynamic_scaling = self.compute_dtype == torch.float16
        self._scale_window = 200
        self._scale = 2.0 ** 15 if self._dynamic_scaling else 1.0
        self._good_steps = 0
        self.block = block
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.mesh = mesh if mesh is not None else auto_mesh()
        self.seq_axis = seq_axis
        self._rule = param_rule or default_param_rule
        self._data_axes = tuple(
            a for a in ((DP, SP) if seq_axis is not None else (DP,))
            if self.mesh.axis_size(a) > 1)

        self._train_names, self._aux_names = split_params(block)
        self._param_objs = dict(block.collect_params().items())

        def place(name):
            a = self._param_objs[name].data().data.detach()
            sh = NamedSharding(self.mesh, self._rule(name, tuple(a.shape),
                                                     self.mesh))
            st = global_put(a, sh)
            # a fresh buffer: the block keeps its own arrays
            return ShardedTensor(st.local.clone(), sh, st.shape)

        self.params: Dict[str, ShardedTensor] = {
            n: place(n) for n in self._train_names}
        self.aux: Dict[str, ShardedTensor] = {
            n: place(n) for n in self._aux_names}
        init_fn, self._update_fn = pure_rule(optimizer)
        self.states = {n: init_fn(n, self.params[n].local)
                       for n in self._train_names}
        self.t = 0
        self._host_t = 0
        self._fwd = functionalize(block, train_mode=True)
        self._last_shapes = None
        self._graphs: Dict[tuple, tuple] = {}

    # ------------------------------------------------------------------
    def _lr_wd(self):
        """Host scalars: the lr schedule and per-parameter multipliers."""
        opt = self.optimizer
        base_lr = opt.learning_rate
        lrs, wds = {}, {}
        for n in self._train_names:
            p = self._param_objs[n]
            lrs[n] = float(base_lr * p.lr_mult)
            wds[n] = float(opt.wd * p.wd_mult)
        return lrs, wds

    def _data_reduce(self, x):
        return C.reducer(self.mesh, self._data_axes)(x)

    def _data_ranks(self) -> int:
        return int(np.prod([self.mesh.axis_size(a)
                            for a in self._data_axes]))

    def _full(self, st: ShardedTensor) -> torch.Tensor:
        if st.sharding.is_fully_replicated():
            return st.local
        return st.full_tensor()

    def _loss_and_grads(self, xl, yl, sync=True):
        """This rank's share of the global mean loss, its gradients (not
        yet reduced over the data axes, in the master dtype) and the new
        aux values."""
        cdt = self.compute_dtype
        leaves = {n: self._full(self.params[n]).detach().requires_grad_(True)
                  for n in self._train_names}
        ps = leaves
        d = xl
        if cdt is not None:
            ps = {n: (p.to(cdt) if p.is_floating_point() else p)
                  for n, p in leaves.items()}
            d = xl.to(cdt) if xl.is_floating_point() else xl
        aux = {n: self.aux[n].local for n in self._aux_names}
        ranks = self._data_ranks() if sync else 1
        scope = batch_stats_scope(self._data_reduce, ranks) \
            if ranks > 1 else contextlib.nullcontext()
        with mesh_scope(self.mesh), scope:
            outs, new_aux = self._fwd(ps, aux, d)
            with autograd._Scope(True, True):
                loss = self.loss_fn(NDArray(outs[0]), NDArray(yl))
        ld = (loss.data if isinstance(loss, NDArray) else loss).float()
        part = ld.sum() / (ld.numel() * ranks)
        wanted = [leaves[n] for n in self._train_names]
        grads = torch.autograd.grad(part * self._scale, wanted,
                                    allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g.to(w.dtype)
                 for g, w in zip(grads, wanted)]
        return part.detach(), grads, new_aux

    def _reduce_grads(self, grads):
        """The gradients summed over the data axes: one bucket per dtype,
        summed in rank order."""
        if not self._data_axes:
            return grads
        out = list(grads)
        by_dtype: Dict[torch.dtype, list] = {}
        for i, g in enumerate(grads):
            by_dtype.setdefault(g.dtype, []).append(i)
        with mesh_scope(self.mesh):
            for idx in by_dtype.values():
                flat = torch.cat([grads[i].reshape(-1) for i in idx])
                for a in self._data_axes:
                    flat = C._psum_raw(flat, self.mesh, a)
                off = 0
                for i in idx:
                    n = grads[i].numel()
                    out[i] = flat[off:off + n].view_as(grads[i])
                    off += n
        return out

    @property
    def captured(self) -> bool:
        """Whether steps run as CUDA graphs (the module docstring)."""
        from ..graph_compile import graph_compile_enabled
        return self.mesh.device.type == "cuda" and self.mesh.size == 1 \
            and not self._dynamic_scaling and graph_compile_enabled()

    def _step_captured(self, xl, yl):
        """One step as a CUDA graph replay (the first of a shape set: the
        eager warm-up, then the capture)."""
        from .. import random as _random
        from ..graph_compile import CapturedGraph, warm_up
        lrs, wds = self._lr_wd()
        t1 = self.t + 1
        dev = self.mesh.device
        key = (tuple(xl.shape), xl.dtype, tuple(yl.shape), yl.dtype)
        entry = self._graphs.get(key)
        fresh = entry is None
        if fresh:
            x_buf, y_buf = torch.empty_like(xl), torch.empty_like(yl)
            # the scalars in the masters' widest dtype: a float64 step
            # reads lr and wd as the eager step's Python floats give them
            wide = torch.float64 if any(
                p.local.dtype == torch.float64
                for p in self.params.values()) else torch.float32
            scal = torch.zeros(2 * len(self._train_names) + 1, dtype=wide,
                               device=dev)
            entry = [x_buf, y_buf, scal, None]
            self._graphs[key] = entry
        x_buf, y_buf, scal = entry[:3]
        with torch.no_grad():
            x_buf.copy_(xl)
            y_buf.copy_(yl)
            scal.copy_(torch.tensor(
                [lrs[n] for n in self._train_names] +
                [wds[n] for n in self._train_names] + [float(t1)],
                dtype=scal.dtype))
        k = len(self._train_names)

        def body():
            part, grads, new_aux = self._loss_and_grads(x_buf, y_buf)
            with torch.no_grad():
                for j, (n, g) in enumerate(zip(self._train_names, grads)):
                    st = self.params[n]
                    w, state = self._update_fn(st.local, g, self.states[n],
                                               scal[2 * k], scal[j],
                                               scal[k + j])
                    st.local.copy_(w)
                    for name, v in state.items():
                        self.states[n][name].copy_(v)
                for n in self._aux_names:
                    self.aux[n].local.copy_(new_aux[n])
            return part

        if fresh:
            part = warm_up(body, dev)
            entry[3] = CapturedGraph(body, dev,
                                     _random.generator(dev))
        else:
            part = entry[3].replay()
        self._last_shapes = key
        self.t = t1
        self._host_t = self.t
        self.optimizer.num_update = self._host_t
        return part.clone()

    def _step_local(self, xl, yl):
        if self.captured:
            return self._step_captured(xl, yl)
        lrs, wds = self._lr_wd()
        self._last_shapes = (tuple(xl.shape), xl.dtype, tuple(yl.shape),
                             yl.dtype)
        part, grads, new_aux = self._loss_and_grads(xl, yl)
        grads = self._reduce_grads(grads)
        with mesh_scope(self.mesh):
            loss = self._data_reduce(part)
        s = self._scale
        grads = [g / s for g in grads] if s != 1.0 else grads
        finite = True
        if self._dynamic_scaling:
            ok = torch.ones((), dtype=torch.bool, device=part.device)
            for g in grads:
                ok = ok & torch.isfinite(g).all()
            finite = bool(ok)
        if finite:
            t1 = self.t + 1
            with torch.no_grad():
                for n, g in zip(self._train_names, grads):
                    st = self.params[n]
                    g = st.sharding.shard(g)
                    w, state = self._update_fn(st.local, g, self.states[n],
                                               t1, lrs[n], wds[n])
                    st.local = w.to(st.local.dtype)
                    self.states[n] = state
                for n in self._aux_names:
                    a = self.aux[n]
                    a.local = new_aux[n].detach().to(a.local.dtype)
            self.t = t1
        if self._dynamic_scaling:
            if finite:
                self._good_steps += 1
                if self._good_steps >= self._scale_window:
                    self._scale *= 2.0
                    self._good_steps = 0
            else:
                self._scale = max(self._scale * 0.5, 1.0)
                self._good_steps = 0
        self._host_t = self.t
        self.optimizer.num_update = self._host_t
        return loss

    # ------------------------------------------------------------------
    def step(self, data, label):
        """One training step on the global batch (``data``, ``label``: the
        same on every rank, or already placed by `place_inputs`).  Returns
        the global mean loss, a 0-dim tensor with the same bits on every
        rank."""
        x, y = self.place_inputs(data, label)
        return self._step_local(x.local, y.local)

    def step_many(self, data, label):
        """K steps, one per leading microbatch: ``data[k]`` is step k's
        batch.  Returns the (K,) losses."""
        x, y = self.place_inputs(data, label, microbatched=True)
        return torch.stack([self._step_local(x.local[k], y.local[k])
                            for k in range(x.local.shape[0])])

    def place_inputs(self, data, label, microbatched: bool = False):
        """Place a (data, label) pair with the trainer's input shardings
        (a leading K axis if ``microbatched``): each rank keeps its rows
        on its device.  Placed inputs pass through `step` as they are;
        the copy happens here, where `DeviceFeed` overlaps it."""
        lead = 1 if microbatched else 0

        def put(v, label=False):
            if isinstance(v, ShardedTensor):
                return v
            t = v.data if isinstance(v, NDArray) else v
            t = torch.as_tensor(np.asarray(t)) if not isinstance(
                t, torch.Tensor) else t
            # a label is split on the sequence axis too when it has one
            seq = self.seq_axis if self.seq_axis is not None and not (
                label and t.dim() <= lead + self.seq_axis) else None
            spec = batch_pspec(t.dim(), self.mesh, seq, lead_axes=lead)
            return global_put(t, NamedSharding(self.mesh, spec))

        return put(data), put(label, label=True)

    # ------------------------------------------------------------------
    def sync_to_block(self):
        """Write the weights back into the Gluon Parameters (for
        save_parameters or serving)."""
        for n, st in {**self.params, **self.aux}.items():
            self._param_objs[n].set_data(NDArray(self._full(st).detach()))

    def compiled_cost_analysis(self):
        """``{"flops": n}``: the floating-point operations of one rank's
        forward and backward at the shapes of the last step, counted by
        ``torch.utils.flop_counter.FlopCounterMode`` (in place of XLA's
        cost analysis; the batch moments are taken locally for it).
        None before the first step."""
        if self._last_shapes is None:
            return None
        from torch.utils.flop_counter import FlopCounterMode
        xs, xdt, ys, ydt = self._last_shapes
        dev = self.mesh.device
        x = torch.zeros(xs, dtype=xdt, device=dev)
        y = torch.zeros(ys, dtype=ydt, device=dev)
        counter = FlopCounterMode(display=False)
        with counter:
            self._loss_and_grads(x, y, sync=False)
        return {"flops": float(counter.get_total_flops())}

    @property
    def loss_scale(self) -> float:
        """The dynamic loss scale (1.0 unless compute_dtype is fp16)."""
        return float(self._scale) if self._dynamic_scaling else 1.0
