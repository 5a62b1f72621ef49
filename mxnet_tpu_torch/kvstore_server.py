"""KVStore server role (the counterpart of `mxnet_tpu/kvstore_server.py`;
reference `python/mxnet/kvstore_server.py`).

In the reference, processes launched with ``DMLC_ROLE=server`` import
the package, which blocks in ``MXKVStoreRunServer`` applying pushed
updates until the job ends.  The same import-time contract holds here,
so the unchanged `tools/launch.py -s 1` spawns a server from the same
command as its workers:

* under ``DMLC_ROLE=worker`` (or no role) importing it does nothing;
* under ``DMLC_ROLE=server`` with the fork's ``BYTEPS_ENABLE_ASYNC``
  hook set, this process BECOMES the asynchronous parameter server
  (`ps_server.KVStoreServer`, on the host), restoring
  ``MXTPU_PS_SNAPSHOT`` when it exists and writing it at exit, and
  serves until a worker sends stop;
* under ``DMLC_ROLE=server``/``scheduler`` otherwise it logs and exits
  0: a ``dist_sync`` store reduces over the process group, with no
  server role.
"""
import logging
import os
import sys


class KVStoreServer(object):
    """The reference's server-loop object.  ``run()`` returns at once:
    a ``dist_sync`` store applies its updates on the workers."""

    def __init__(self, kvstore):
        self.kvstore = kvstore
        self.handle = getattr(kvstore, "handle", None)

    def _controller(self):
        def server_controller(cmd_id, cmd_body, _):
            if cmd_id == 0:  # reference: pickled optimizer install
                # mxtpu-lint: disable=pickle-in-wire -- the reference's pickled optimizer command
                import pickle
                self.kvstore.set_optimizer(pickle.loads(cmd_body))
            else:
                logging.warning("server: unknown command (%s)", cmd_id)
        return server_controller

    def run(self):
        logging.info("the kvstore server role is the workers' own "
                     "collective here; returning")


def _finish_package_import():
    """The server serves from inside the package's import (the
    reference's contract), so that import never ends.  Mark the package
    and this module imported before serving: a handler thread's import
    (the module of an unpickled optimizer, an op's lazy import of a
    sibling module) would otherwise wait forever on the import lock of a
    package still being imported.  Every submodule is imported by now:
    this module is the package's last import."""
    for name in (__package__, __name__):
        spec = getattr(sys.modules.get(name), "__spec__", None)
        if spec is not None:
            spec._initializing = False


def _init_kvstore_server_module():
    # mxtpu-lint: disable=raw-env-read -- DMLC_* is the launcher's wire
    # protocol (tracker-assigned per process), not a user knob
    role = os.environ.get("DMLC_ROLE", "worker")
    if role == "server":
        from . import config, ps_server
        if ps_server.async_enabled():
            # BYTEPS_ENABLE_ASYNC (kvstore_dist_server.h:182): this
            # process is the async PS, serving like the reference's
            # MXKVStoreRunServer loop
            # mxtpu-lint: disable=raw-env-read -- DMLC_* launcher protocol
            nw = int(os.environ.get("DMLC_NUM_WORKER", "1"))
            # crash recovery: a restarted server resumes from the
            # snapshot (workers replay their in-flight request; the
            # restored dedup window keeps the replay exactly-once)
            snap_path = config.get_env("MXTPU_PS_SNAPSHOT", "")
            restore = None
            if snap_path and os.path.exists(snap_path):
                with open(snap_path, "rb") as f:
                    restore = f.read()
                logging.info("async PS restoring state from %s "
                             "(%d bytes)", snap_path, len(restore))
            srv = ps_server.KVStoreServer(nw, port=ps_server.ps_port(),
                                          host="0.0.0.0",
                                          restore=restore)
            logging.info("async PS serving on :%d (workers=%d)",
                         srv.port, nw)
            _finish_package_import()
            srv.serve_forever()  # until a worker sends 'stop'
            if snap_path:
                with open(snap_path, "wb") as f:
                    f.write(srv.snapshot())
            logging.info("async PS stats at exit: %s", srv.stats_dict())
            sys.exit(0)
    if role in ("server", "scheduler"):
        logging.info("DMLC_ROLE=%s has no work here (a dist_sync store "
                     "reduces over the process group); exiting cleanly",
                     role)
        sys.exit(0)


_init_kvstore_server_module()
