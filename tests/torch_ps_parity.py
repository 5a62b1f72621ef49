"""Run a parameter-server test file of the JAX package on the PyTorch
port, and hold each of its tests against the JAX package on the same
request sequence.

`port_copy(fname, namespace)` execs the JAX test file's source into the
port test module's namespace with the package imports pointed at
`mxnet_tpu_torch` (and its worker scripts at the port's
``tests/torch_*_worker.py``): the port's tests are the JAX tests, with
the same names, inputs and closed-form assertions.  The source is
compiled under its own path, so a failure's traceback shows the JAX
file's lines.

`port_tests(fname, skip)` gives a JAX test file's test functions exec'd
the same way, each run under ``with cpu():``, for files that mix them
with tests of their own.

`held(request, monkeypatch, jax_module)` is the body of an autouse
fixture: it records every value the port's `PSClient`s read
(``pull``, ``pull_batch``, ``pull_rows``, ``embed_pull``) while the test
runs under ``with cpu():`` (the port's arrays default to the card), then
runs the JAX module's test of the same name, with the same parameters,
recording its clients the same way, and requires the two records to be
equal: per client (in creation order), the same reads in the same
order, each value of the same dtype, shape and bytes.
"""
import contextlib
import inspect
import os
import re
import threading

import numpy as np

_TESTS = os.path.dirname(os.path.abspath(__file__))

_SUBS = (
    (r"\bimport mxnet_tpu as mx\b", "import mxnet_tpu_torch as mx"),
    (r"\bfrom mxnet_tpu import\b", "from mxnet_tpu_torch import"),
    (r"\bfrom mxnet_tpu\.", "from mxnet_tpu_torch."),
    (r'"(dist_async_worker|ps_chaos_worker|ps_elastic_worker|'
     r'embed_chaos_worker|dist_sync_worker|preempt_chaos_worker|'
     r'ckpt_chaos_worker)\.py"', r'"torch_\1.py"'),
)

_READS = ("pull", "pull_batch", "pull_rows", "embed_pull")


def port_copy(fname, namespace):
    """Exec ``tests/<fname>`` into ``namespace`` with the port's
    imports."""
    path = os.path.join(_TESTS, fname)
    with open(path) as f:
        src = f.read()
    for pat, rep in _SUBS:
        src = re.sub(pat, rep, src)
    exec(compile(src, path, "exec"), namespace)


def port_tests(fname, skip=None):
    """The test functions of ``tests/<fname>`` exec'd on the port
    (`port_copy`), each wrapped to run under ``with cpu():`` (the port's
    arrays default to the card), by name.  ``skip`` maps the names left
    out to the reason each does not apply to the port."""
    import functools

    import mxnet_tpu_torch as mt

    ns = {"__name__": "port_" + fname[:-3],
          "__file__": os.path.join(_TESTS, fname)}
    port_copy(fname, ns)
    out = {}
    for name, fn in ns.items():
        if not name.startswith("test_") or not callable(fn) or \
                name in (skip or {}):
            continue

        @functools.wraps(fn)
        def run(*args, _fn=fn, **kwargs):
            with mt.cpu():
                return _fn(*args, **kwargs)
        out[name] = run
    missing = set(skip or {}) - set(ns)
    assert not missing, f"{fname} has no tests {sorted(missing)}"
    return out


class Recorder:
    """The values each `PSClient` of one package read, by client."""

    def __init__(self):
        self.by_client = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def on(self, ps_module):
        cls = ps_module.PSClient
        saved = {"__init__": cls.__init__}
        saved.update((n, getattr(cls, n)) for n in _READS)
        rec = self

        def init(client, *a, **k):
            saved["__init__"](client, *a, **k)
            with rec._lock:
                client._parity_idx = len(rec.by_client)
                rec.by_client.append([])

        def reader(name):
            orig = saved[name]

            def read(client, *a, **k):
                out = orig(client, *a, **k)
                idx = getattr(client, "_parity_idx", None)
                if idx is not None:
                    with rec._lock:
                        rec.by_client[idx].append((name, _snap(out)))
                return out
            return read

        cls.__init__ = init
        for n in _READS:
            setattr(cls, n, reader(n))
        try:
            yield self
        finally:
            for n, f in saved.items():
                setattr(cls, n, f)


def _snap(v):
    if isinstance(v, (list, tuple)):
        return [_snap(x) for x in v]
    a = np.asarray(v)
    return (str(a.dtype), a.shape, a.tobytes())


def _unwrap(fx):
    get = getattr(fx, "_get_wrapped_function", None)
    return get() if get is not None else fx


def _autouse_fixtures(module):
    out = []
    for obj in vars(module).values():
        marker = getattr(obj, "_fixture_function_marker", None)
        if marker is not None and marker.autouse:
            out.append(_unwrap(obj))
    return out


def held(request, monkeypatch, jax_module, skip=()):
    """Generator body of the port test file's autouse fixture."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import ps_server as tps
    name = request.function.__name__
    port = Recorder()
    with port.on(tps), mt.cpu():
        yield
    if name in skip:
        return
    from mxnet_tpu import fault_injection as jfi
    from mxnet_tpu import ps_server as jps
    jfn = getattr(jax_module, name)
    params = dict(getattr(getattr(request.node, "callspec", None),
                          "params", {}))
    kwargs = {}
    for p in inspect.signature(jfn).parameters:
        if p == "monkeypatch":
            kwargs[p] = monkeypatch
        elif p == "tmp_path":
            kwargs[p] = request.getfixturevalue(
                "tmp_path_factory").mktemp("jax_ref")
        else:
            kwargs[p] = params[p]
    jfi.clear()
    gens = []
    for fx in _autouse_fixtures(jax_module):
        fargs = {p: monkeypatch for p in inspect.signature(fx).parameters}
        g = fx(**fargs)
        if inspect.isgenerator(g):
            next(g)
            gens.append(g)
    ref = Recorder()
    try:
        with ref.on(jps):
            jfn(**kwargs)
    finally:
        for g in reversed(gens):
            next(g, None)
        jfi.clear()
    assert len(port.by_client) == len(ref.by_client), \
        (len(port.by_client), len(ref.by_client))
    for i, (mine, theirs) in enumerate(zip(port.by_client,
                                           ref.by_client)):
        assert [n for n, _ in mine] == [n for n, _ in theirs], (i, name)
        for j, ((op, a), (_, b)) in enumerate(zip(mine, theirs)):
            assert a == b, f"client {i} read {j} ({op}) differs from " \
                "the JAX package's"
