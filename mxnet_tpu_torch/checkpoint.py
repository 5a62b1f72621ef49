"""Crash-consistent training checkpoints with deterministic resume (the
counterpart of `mxnet_tpu/checkpoint.py`, with its layout and manifest).

A checkpoint is a per-step directory whose ``MANIFEST.json`` is written
last, through the same atomic rename as every member file
(`serialization.atomic_write`): the manifest appearing is the commit.
The manifest records each member's size and CRC32, so `latest_valid`
scans back past torn, uncommitted or corrupt steps to the newest whole
one, and ``keep_n`` retention drops the oldest committed steps and any
aborted directory after each commit::

    <dir>/step-00000007/params.params      # arg:/aux:-prefixed NDArrays
    <dir>/step-00000007/optimizer.states   # Updater.get_states pickle
    <dir>/step-00000007/MANIFEST.json      # the commit, written last

``files``, ``step``, ``epoch`` and ``batch`` mean the same in both
packages, so either one's params and optimizer states restore into the
other; ``rng`` is the writing package's own generator state
(`random.get_state`), which only that package reads.

``MXTPU_CKPT_DIR`` makes `Module.fit` checkpoint every epoch and resume
from `latest_valid()` on restart (`auto_manager`), with retention
``MXTPU_CKPT_KEEP``.  The JAX package's ``MXTPU_CKPT_FAULT_PLAN``
(seeded write faults) waits for the port of `fault_injection.py`.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
import zlib
from typing import Any, Dict, Optional

from . import config as _config
from . import random as _random
from .serialization import (CheckpointCorruptError, atomic_write, crc32_file,
                            load_ndarrays, read_payload, save_ndarrays,
                            split_footer, strip_arg_aux)

__all__ = ["CheckpointManager", "Checkpoint", "auto_manager"]

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_VERSION = 1
_STEP_RE = re.compile(r"^step-(\d{8})$")
_PARAMS_FILE = "params.params"
_STATES_FILE = "optimizer.states"


class Checkpoint:
    """A validated, committed checkpoint: its step, directory and parsed
    manifest."""

    def __init__(self, step: int, directory: str, manifest: Dict[str, Any]):
        self.step = step
        self.directory = directory
        self.manifest = manifest

    @property
    def epoch(self):
        return self.manifest.get("epoch")

    @property
    def batch(self):
        return self.manifest.get("batch")

    def path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def __repr__(self):
        return (f"<Checkpoint step={self.step} epoch={self.epoch} "
                f"dir={self.directory!r}>")


class CheckpointManager:
    """One writer's rolling checkpoint directory: `save` commits a whole
    snapshot, `latest_valid` finds the newest that passes validation,
    `restore` applies one to a Module, a Gluon Trainer or Block, and the
    generators."""

    def __init__(self, directory: str, keep_n: Optional[int] = None,
                 logger=logging):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        if keep_n is None:
            keep_n = _config.get_env("MXTPU_CKPT_KEEP")
        self.keep_n = max(1, int(keep_n))
        self.logger = logger
        # the step `latest_valid` last returned: retention never deletes
        # it under a caller about to load it
        self._pinned_step: Optional[int] = None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{int(step):08d}")

    def _scan(self):
        """Every step directory present, as sorted [(step, path)]."""
        try:
            entries = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        out = []
        for name in entries:
            m = _STEP_RE.match(name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, name)))
        out.sort()
        return out

    # -- write side -----------------------------------------------------
    def save(self, step: int, params: Optional[Dict[str, Any]] = None,
             optimizer_states: Optional[bytes] = None, trainer=None,
             updater=None, epoch: Optional[int] = None,
             batch: Optional[int] = None, rng_state=True,
             extra: Optional[Dict[str, Any]] = None) -> Checkpoint:
        """Commit one checkpoint: ``params`` (name -> NDArray, ``arg:``/
        ``aux:`` prefixed where they differ), optimizer states from
        ``optimizer_states`` bytes, a Gluon ``trainer`` or an ``updater``,
        and with ``rng_state=True`` the generators.  A crash before the
        manifest lands leaves an aborted directory that `latest_valid`
        skips and retention removes."""
        d = self.step_dir(step)
        if os.path.isdir(d):
            shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d, exist_ok=True)
        files: Dict[str, Dict[str, int]] = {}
        if params:
            p = os.path.join(d, _PARAMS_FILE)
            save_ndarrays(p, params)
            files[_PARAMS_FILE] = {"bytes": os.path.getsize(p),
                                   "crc32": crc32_file(p), "footer": True}
        if optimizer_states is None:
            if trainer is not None:
                optimizer_states = trainer.state_bytes()
            elif updater is not None:
                optimizer_states = updater.get_states(dump_optimizer=True)
        if optimizer_states is not None:
            p = os.path.join(d, _STATES_FILE)
            atomic_write(p, optimizer_states, checksum=True)
            files[_STATES_FILE] = {"bytes": os.path.getsize(p),
                                   "crc32": crc32_file(p), "footer": True}
        if rng_state is True:
            rng_state = _random.get_state()
        manifest = {
            "manifest_version": MANIFEST_VERSION,
            "step": int(step),
            "epoch": None if epoch is None else int(epoch),
            "batch": None if batch is None else int(batch),
            "rng": rng_state or None,
            "files": files,
            "extra": extra or {},
            "wallclock": time.time(),
        }
        delay = _config.get_env("MXTPU_CKPT_COMMIT_DELAY")
        if delay and delay > 0:
            time.sleep(float(delay))
        body = json.dumps(manifest, indent=2, sort_keys=True).encode("utf-8")
        # plain JSON, no footer: the rename is its integrity boundary and
        # the CRCs inside it cover the data
        atomic_write(os.path.join(d, MANIFEST_NAME), body, checksum=False)
        self._apply_retention(committed_step=int(step))
        return Checkpoint(int(step), d, manifest)

    def save_module(self, module, step: int, epoch: Optional[int] = None,
                    batch: Optional[int] = None,
                    extra: Optional[Dict[str, Any]] = None) -> Checkpoint:
        """A bound Module's parameters (``arg:``/``aux:`` prefixed) and
        the optimizer states of the updater that drives it."""
        arg, aux = module.get_params()
        params = {f"arg:{k}": v for k, v in (arg or {}).items()}
        params.update({f"aux:{k}": v for k, v in (aux or {}).items()})
        getter = getattr(module, "_active_updater", None)
        upd = getter() if getter is not None else None
        return self.save(step, params=params, updater=upd, epoch=epoch,
                         batch=batch, extra=extra)

    def _apply_retention(self, committed_step: int) -> None:
        """Keep the newest ``keep_n`` committed checkpoints (and the pinned
        one); delete older ones and every aborted directory not newer than
        this commit."""
        committed, aborted = [], []
        for step, path in self._scan():
            if os.path.exists(os.path.join(path, MANIFEST_NAME)):
                committed.append((step, path))
            else:
                aborted.append((step, path))
        for step, path in committed[:-self.keep_n]:
            if step != self._pinned_step:
                shutil.rmtree(path, ignore_errors=True)
        for step, path in aborted:
            if step <= committed_step:
                shutil.rmtree(path, ignore_errors=True)

    # -- read side ------------------------------------------------------
    def validate(self, step: int) -> Optional[Checkpoint]:
        """The checkpoint of ``step`` if its manifest is committed and
        parses and every member file is present with its size, CRC32 and
        own footer; else None, the reason logged."""
        d = self.step_dir(step)
        mpath = os.path.join(d, MANIFEST_NAME)
        if not os.path.exists(mpath):
            self.logger.debug("checkpoint %s: uncommitted (no manifest)", d)
            return None
        try:
            with open(mpath, "rb") as f:
                manifest = json.loads(f.read().decode("utf-8"))
        except FileNotFoundError:
            self.logger.debug("checkpoint %s: vanished concurrently", d)
            return None
        except (ValueError, OSError) as e:
            self.logger.warning("checkpoint %s: unreadable manifest (%s)",
                                d, e)
            return None
        files = manifest.get("files")
        if not isinstance(files, dict):
            self.logger.warning("checkpoint %s: malformed manifest", d)
            return None
        for name, meta in files.items():
            p = os.path.join(d, name)
            try:
                with open(p, "rb") as f:
                    raw = f.read()
            except FileNotFoundError:
                self.logger.warning("checkpoint %s: missing file %s", d, name)
                return None
            except OSError as e:
                self.logger.warning("checkpoint %s: unreadable %s (%s)", d,
                                    name, e)
                return None
            if len(raw) != meta.get("bytes"):
                self.logger.warning(
                    "checkpoint %s: %s is %d bytes, manifest says %s", d,
                    name, len(raw), meta.get("bytes"))
                return None
            crc = zlib.crc32(raw) & 0xFFFFFFFF
            if crc != meta.get("crc32"):
                self.logger.warning(
                    "checkpoint %s: %s crc32 0x%08x != manifest 0x%08x", d,
                    name, crc, meta.get("crc32") or 0)
                return None
            if meta.get("footer"):
                # the file's own footer catches corruption that landed
                # before the manifest recorded its checksum
                try:
                    _, foot = split_footer(raw, what=p)
                except CheckpointCorruptError as e:
                    self.logger.warning("checkpoint %s: %s", d, e)
                    return None
                if foot is None:
                    self.logger.warning("checkpoint %s: %s lost its "
                                        "integrity footer", d, name)
                    return None
        return Checkpoint(int(step), d, manifest)

    def latest_valid(self) -> Optional[Checkpoint]:
        """The newest checkpoint that passes `validate`, scanning back
        past the others; None if none does.  Its step is pinned against
        this manager's retention until the next call."""
        for step, _path in reversed(self._scan()):
            ck = self.validate(step)
            if ck is not None:
                self._pinned_step = ck.step
                return ck
        self._pinned_step = None
        return None

    def load(self, ckpt: Optional[Checkpoint] = None
             ) -> Optional[Dict[str, Any]]:
        """A checkpoint (by default `latest_valid`) as a dict: ``step``,
        ``epoch``, ``batch``, ``rng``, ``extra``, ``params`` (name ->
        NDArray on the CPU, or None) and ``optimizer_states`` (bytes or
        None)."""
        auto = ckpt is None
        if auto:
            ckpt = self.latest_valid()
        if ckpt is None:
            return None
        try:
            return self._load_files(ckpt)
        except FileNotFoundError:
            if not auto:
                raise
            # another process's retention removed it between the scan and
            # the read: scan once more
            ckpt = self.latest_valid()
            return None if ckpt is None else self._load_files(ckpt)

    def _load_files(self, ckpt: Checkpoint) -> Dict[str, Any]:
        files = ckpt.manifest.get("files", {})
        return {
            "step": ckpt.step, "epoch": ckpt.epoch, "batch": ckpt.batch,
            "rng": ckpt.manifest.get("rng"),
            "extra": ckpt.manifest.get("extra", {}),
            "params": (load_ndarrays(ckpt.path(_PARAMS_FILE))
                       if _PARAMS_FILE in files else None),
            "optimizer_states": (read_payload(ckpt.path(_STATES_FILE))
                                 if _STATES_FILE in files else None),
        }

    def restore(self, ckpt: Optional[Checkpoint] = None, module=None,
                trainer=None, block=None, restore_rng: bool = True):
        """Apply a checkpoint (by default `latest_valid`) to a Module, a
        Gluon Trainer and Block, and (``restore_rng``) the generators.
        Returns the loaded dict, or None when no checkpoint is valid."""
        state = self.load(ckpt)
        if state is None:
            return None
        params = state["params"]
        if params and module is not None:
            arg, aux = split_arg_aux(params)
            module.set_params(arg, aux, allow_missing=False)
        if params and block is not None:
            loaded, _ = strip_arg_aux(params)
            for name, p in block._collect_params_with_prefix().items():
                if name in loaded:
                    p.set_data(loaded[name])
        blob = state["optimizer_states"]
        if blob is not None:
            if trainer is not None:
                trainer.load_state_bytes(blob)
            elif module is not None:
                module.load_optimizer_states_bytes(blob)
        if restore_rng and state.get("rng"):
            _random.set_state(state["rng"])
        return state


def split_arg_aux(params: Dict[str, Any]):
    """``(arg, aux)`` from ``arg:``/``aux:``-prefixed names (a bare name
    is an argument)."""
    arg, aux = {}, {}
    for k, v in params.items():
        if k.startswith("aux:"):
            aux[k[4:]] = v
        else:
            arg[k[4:] if k.startswith("arg:") else k] = v
    return arg, aux


def auto_manager(logger=logging) -> Optional[CheckpointManager]:
    """The auto-resume manager: a CheckpointManager at ``MXTPU_CKPT_DIR``
    (retention ``MXTPU_CKPT_KEEP``), or None when the variable is
    unset."""
    d = _config.get_env("MXTPU_CKPT_DIR")
    if not d:
        return None
    return CheckpointManager(d, logger=logger)
