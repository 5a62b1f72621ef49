"""The port's top-level front-end modules (`registry`, `resource`,
`runtime`, `rtc`, `libinfo`, `misc`, `util`, the doc builders,
`notebook`) against the JAX package's, on the CPU.

* The JAX package's own `tests/test_frontend_misc.py` and `tests/
  test_aux.py` (its resource, runtime and test-utility cases among them)
  run on the port (`torch_ps_parity.port_tests`), each test under ``with
  cpu():``, but for the cases in ``SKIP``, each with its reason.
* Parity: the initializer registry, the runtime feature names, the
  legacy scheduler, the doc builders, `util`'s dtype codes and a
  `PandasLogger`'s frames equal in both packages.
* The port's own contracts: `rtc.CudaModule` raises `MXNetError` without
  a CUDA device (`PallasModule` runs Python kernels on the CPU; the
  JAX package's `tests/test_breadth.py::test_rtc_pallas_module` asserts
  that its `CudaModule` always raises, so only its `PallasModule` half is
  ported); `get_kernel` reads MXNet's C signatures; `libinfo` lists the
  port's native libraries; a temp space is one growing buffer per slot.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mxnet_tpu as jx
import mxnet_tpu_torch as tx
import torch_ps_parity as parity

SKIP = {
    "test_libinfo_paths":
        "asserts the JAX package's `_native` include directory; the "
        "port's libraries are held by test_libinfo_lists_the_port_"
        "libraries below",
    "test_kvstore_server_role_exits_cleanly":
        "its child process imports the JAX package by name; the port's "
        "server role is held by tests/test_torch_kvstore_dist.py",
}

globals().update(parity.port_tests("test_frontend_misc.py", SKIP))
globals().update({f"test_aux_{n[5:]}": f for n, f in
                  parity.port_tests("test_aux.py").items()})


def test_initializer_registry_matches_reference():
    def builtin(pkg):
        reg = pkg.registry.get_registry(pkg.init.Initializer)
        return {k for k, v in reg.items()
                if v.__module__ == pkg.initializer.__name__}
    names = builtin(tx)
    assert names == builtin(jx)
    assert {"xavier", "normal", "uniform", "constant", "lstmbias"} <= names
    blob = jx.init.Xavier(magnitude=2.0).dumps()
    got = tx.init.create(blob)
    assert isinstance(got, tx.init.Xavier) and got.dumps() == blob


def test_runtime_feature_names_match_reference():
    t, j = tx.runtime.Features(), jx.runtime.Features()
    assert list(t) == list(j)
    assert t.is_enabled("CUDA") == torch.cuda.is_available()
    assert not t.is_enabled("TPU") and not t.is_enabled("PALLAS")
    assert [f.name for f in tx.runtime.feature_list()] == list(j)
    with pytest.raises(RuntimeError):
        t.is_enabled("NOT_A_FEATURE")


def test_misc_doc_and_util_match_reference():
    tf, jf = tx.misc.FactorScheduler(7, 0.3), jx.misc.FactorScheduler(7, 0.3)
    assert [tf(i) for i in range(0, 50, 3)] == [jf(i) for i in range(0, 50, 3)]
    args = ("softmax", "Softmax op.", ["data", "axis"], ["NDArray", "int"],
            ["the input", "the axis"])
    assert tx.ndarray_doc._build_doc(*args) == \
        jx.ndarray_doc._build_doc(*args)
    assert tx.symbol_doc._build_doc(*args) == \
        jx.symbol_doc._build_doc(*args)
    for name in ("float32", "float64", "float16", "uint8", "int32", "int8",
                 "int64", "bool"):
        assert tx.util.DTYPE_TO_ID[tx.util.dtype_np(name)] == \
            jx.util.DTYPE_TO_ID[jx.util.dtype_np(name)]
        assert tx.util.dtype_name(name) == jx.util.dtype_name(name)
    assert tx.util.DTYPE_TO_ID[tx.util.dtype_np("bf16")] == 100
    assert tx.util.dtype_name("bf16") == "bfloat16"


def test_pandas_logger_frames_match_reference():
    pytest.importorskip("pandas")
    frames = []
    for pkg in (jx, tx):
        with (tx.cpu() if pkg is tx else parity.contextlib.nullcontext()):
            m = pkg.metric.Accuracy()
            pl = pkg.notebook.callback.PandasLogger(batch_size=4, frequent=2)
            for nbatch in range(5):
                m.update(pkg.nd.array([1, 0, nbatch % 2]),
                         pkg.nd.array([[0., 1.], [1., 0.], [0., 1.]]))
                pl.train_cb(SimpleNamespace(nbatch=nbatch, epoch=0,
                                            eval_metric=m))
            pl.eval_cb(SimpleNamespace(nbatch=5, epoch=0, eval_metric=m))
        frames.append(pl)
    j, t = frames
    for name in ("train", "eval"):
        jd, td = j.all_dataframes[name], t.all_dataframes[name]
        assert list(td.columns) == list(jd.columns)
        for col in ("accuracy", "minibatch_count", "epoch"):
            np.testing.assert_array_equal(np.asarray(td[col], float),
                                          np.asarray(jd[col], float),
                                          err_msg=f"{name} {col}")


def test_cuda_module_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tx.MXNetError, match="no CUDA device"):
        tx.rtc.CudaModule('extern "C" __global__ void f() {}')


def test_pallas_module_runs_python_kernels():
    """`tests/test_breadth.py::test_rtc_pallas_module`'s PallasModule
    half, on the port."""
    mod = tx.rtc.PallasModule(double=lambda x: x * 2)
    k = mod.get_kernel("double")
    with tx.cpu():
        out = k.launch([tx.nd.ones((2, 2))])
    np.testing.assert_allclose(out.asnumpy(), 2 * np.ones((2, 2)))
    with pytest.raises(tx.MXNetError):
        mod.get_kernel("missing")


def test_cuda_kernel_signatures():
    mod = tx.rtc.CudaModule.__new__(tx.rtc.CudaModule)
    mod._lowered = {"axpy<float>": "_Z4axpyIfEvPKT_PS0_S0_"}
    k = mod.get_kernel("axpy<float>", "const float *x, float *y, "
                       "float alpha")
    assert k._symbol == "_Z4axpyIfEvPKT_PS0_S0_"
    assert [(p, str(d), c) for p, d, c in k._args] == [
        (True, "float32", True), (True, "float32", False),
        (False, "float32", False)]
    k = mod.get_kernel("scale", "double* y, int n, unsigned char flag, "
                       "int64_t m")
    assert k._symbol == "scale"
    assert [(p, str(d)) for p, d, _ in k._args] == [
        (True, "float64"), (False, "int32"), (False, "uint8"),
        (False, "int64")]
    with pytest.raises(tx.MXNetError, match="unsupported"):
        mod.get_kernel("f", "float3 v")
    with pytest.raises(tx.MXNetError, match="invalid"):
        mod.get_kernel("f", "float *x, 1 + 2")
    with pytest.raises(tx.MXNetError, match="gpu context"):
        k.launch([], tx.cpu(), (1,), (1,))


def test_libinfo_lists_the_port_libraries(tmp_path, monkeypatch):
    from mxnet_tpu_torch import io_native
    from mxnet_tpu_torch.ops import cuda_build
    assert tx.libinfo.find_include_path() == cuda_build.CSRC_DIR
    if io_native.ensure_built():
        paths = tx.libinfo.find_lib_path()
        assert io_native.lib_path() in paths
        assert all(p.endswith(".so") for p in paths)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="List of candidates") as e:
        tx.libinfo.find_lib_path()
    assert "flash_attn_fwd" in str(e.value)


def test_temp_space_grows_and_aliases():
    from mxnet_tpu_torch import resource
    with tx.cpu(1):
        mgr = resource._manager()
        r = resource.request(resource.ResourceRequest.kTempSpace)
        a = r.get_space((4, 5))
        assert r.space_nbytes >= 80 and a.context == tx.cpu(1)
        b = r.get_space((2, 3), dtype=np.int32)
        assert b.dtype == np.int32
        assert b.data.data_ptr() == a.data.data_ptr()   # one buffer a slot
        c = r.get_space((100,), dtype=np.float64)
        assert r.space_nbytes == 800 and c.shape == (100,)
        assert len(mgr._temp_spaces) == 1


def test_resource_streams_per_context_and_slot():
    from mxnet_tpu_torch import resource
    resource.seed(5)
    draws = {}
    for ctx in (tx.cpu(0), tx.cpu(1)):
        with ctx:
            resource.seed(5, ctx)
            r = resource.request(resource.ResourceRequest.kRandom)
            draws[ctx] = r.uniform((6,)).asnumpy()
            assert isinstance(r.get_key(), torch.Generator)
    assert not np.array_equal(draws[tx.cpu(0)], draws[tx.cpu(1)])
    with tx.cpu(0):
        resource.seed(5, tx.cpu(0))
        again = resource.request(resource.ResourceRequest.kRandom)
        np.testing.assert_array_equal(again.uniform((6,)).asnumpy(),
                                      draws[tx.cpu(0)])
        with pytest.raises(tx.MXNetError):
            resource.request("no_such_kind")
