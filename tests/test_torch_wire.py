"""The port's wire codec (`mxnet_tpu_torch.ps_wire`) against the JAX
package's (`mxnet_tpu.ps_wire`): the same object encodes to the same
bytes, each package decodes the other's frames, malformed frames raise
`WireError` in both, and a `ServeClient` of one package talks to a
`ModelServer` of the other."""
import socket
import struct

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import ps_wire as jwire
from mxnet_tpu.predictor import Predictor as JaxPredictor
from mxnet_tpu.serialization import dumps_ndarrays as jdumps
from mxnet_tpu.serving import (CompiledModelPool as JaxPool,
                               ModelServer as JaxServer,
                               ServeClient as JaxClient)

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import ps_wire
from mxnet_tpu_torch.serving import (CompiledModelPool, ModelServer,
                                     ServeClient)

SERVE_TOL = 2e-4
_RNG = np.random.RandomState(0)

OBJECTS = {
    "none": None,
    "bools": (True, False),
    "int": -(1 << 40),
    "float": 3.25e-7,
    "str": "héllo wire",
    "bytes": b"\x00\x01\xff" * 5,
    "f32": _RNG.randn(3, 4).astype(np.float32),
    "f64_scalar": np.float64(2.5),
    "i8": np.arange(-4, 4, dtype=np.int8).reshape(2, 4),
    "u16_empty": np.zeros((0, 3), np.uint16),
    "bool_arr": np.array([True, False, True]),
    "noncontig": _RNG.randn(4, 6).astype(np.float32)[:, ::2],
    "list": [1, 2.0, "x", None],
    "dict": {"a": 1, 2: [3, 4], "arr": np.ones(2, np.int64)},
    "infer": ("infer", 7, {"data": _RNG.rand(2, 5).astype(np.float32)},
              {"_trace": "abc123"}),
    "err": ("err", 3, "overload", "queue full", {"limit": 4}),
    "nested": ((1, (2, (3, [4, {"k": (5,)}]))),),
    "np_int": np.int32(-9),
}


@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_encode_bytes_equal_the_reference(name):
    obj = OBJECTS[name]
    assert ps_wire.encode(obj) == jwire.encode(obj)


def _same(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and \
            np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_each_package_decodes_the_others_frames(name):
    obj = OBJECTS[name]
    assert _same(ps_wire.decode(jwire.encode(obj)),
                 jwire.decode(jwire.encode(obj)))
    assert _same(jwire.decode(ps_wire.encode(obj)),
                 ps_wire.decode(ps_wire.encode(obj)))


def _bad_frames():
    good = jwire.encode(("infer", 1, {"x": np.ones(3, np.float32)}))
    tensor_hdr = jwire.encode(np.ones(2, np.float32))
    lying = bytearray(tensor_hdr)
    # the nbytes field sits just before the raw payload (8 bytes of data)
    struct.pack_into("<Q", lying, len(lying) - 8 - 8, 12)
    return {
        "truncated": good[:-3],
        "bad_magic": b"MXW1" + good[4:],
        "trailing": good + b"\x00",
        "bad_tag": jwire.MAGIC + b"\x7f",
        "lying_nbytes": bytes(lying),
        "bad_dtype": jwire.MAGIC + b"\x07\x03zzz\x00" + b"\x00" * 8,
        "empty": b"",
    }


@pytest.mark.parametrize("name", sorted(_bad_frames()))
def test_malformed_frames_raise_wire_error_in_both(name):
    body = _bad_frames()[name]
    with pytest.raises(jwire.WireError):
        jwire.decode(body)
    with pytest.raises(ps_wire.WireError):
        ps_wire.decode(body)
    assert issubclass(ps_wire.WireError, ConnectionError)


def test_unencodable_type_raises_in_both():
    with pytest.raises(jwire.WireError):
        jwire.encode(object())
    with pytest.raises(ps_wire.WireError):
        ps_wire.encode(object())


def test_frames_cross_a_socket_both_ways():
    a, b = socket.socketpair()
    try:
        obj = OBJECTS["infer"]
        n = ps_wire.send_frame(a, obj)
        assert n == ps_wire.LEN_PREFIX.size + len(ps_wire.encode(obj))
        assert _same(jwire.recv_frame(b), obj)
        jwire.send_frame(b, OBJECTS["dict"])
        assert _same(ps_wire.recv_frame(a), OBJECTS["dict"])
        a.sendall(ps_wire.LEN_PREFIX.pack(ps_wire.MAX_FRAME_BYTES + 1))
        with pytest.raises(ps_wire.WireError):
            ps_wire.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_clean_close_reads_none():
    a, b = socket.socketpair()
    a.close()
    try:
        assert ps_wire.recv_frame(b) is None
    finally:
        b.close()


def test_reply_builders_and_vocabulary_match():
    assert ps_wire.ok_frame(3, {"a": 1}) == jwire.ok_frame(3, {"a": 1})
    assert ps_wire.err_frame(4, "overload", ValueError("x"), {"n": 1}) == \
        jwire.err_frame(4, "overload", ValueError("x"), {"n": 1})
    assert ps_wire.SERVE_OPS == jwire.SERVE_OPS
    assert ps_wire.MAGIC == jwire.MAGIC
    assert set(ps_wire.__all__) == set(jwire.__all__)


# ---------------------------------------------------------------------------
# one package's client against the other's server
# ---------------------------------------------------------------------------

def _mlp(sym_mod):
    data = sym_mod.var("data")
    fc1 = sym_mod.FullyConnected(data, num_hidden=8, name="fc1")
    act = sym_mod.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym_mod.FullyConnected(act, num_hidden=3, name="fc2")
    return sym_mod.softmax(fc2, name="out")


def _params():
    rng = np.random.RandomState(0)
    return {"fc1_weight": rng.randn(8, 5).astype(np.float32),
            "fc1_bias": rng.randn(8).astype(np.float32),
            "fc2_weight": rng.randn(3, 8).astype(np.float32),
            "fc2_bias": rng.randn(3).astype(np.float32)}


@pytest.fixture(scope="module")
def pools():
    blob = jdumps({"arg:" + n: mx.nd.array(a) for n, a in _params().items()})
    json_str = _mlp(mx.sym).tojson()
    jpool = JaxPool(JaxPredictor(json_str, blob, {"data": (4, 5)}),
                    batch_ladder=[1, 2, 4], devices=[mx.cpu().jax_device])
    tpool = CompiledModelPool(
        mt.Predictor(json_str, blob, {"data": (4, 5)}, ctx=mt.cpu()),
        batch_ladder=[1, 2, 4], devices=[mt.cpu()])
    return jpool, tpool


@pytest.mark.parametrize("client,server", [("torch", "jax"),
                                           ("jax", "torch")])
def test_client_of_one_package_serves_from_the_other(pools, client, server):
    jpool, tpool = pools
    srv = (JaxServer(jpool, max_delay_ms=2.0) if server == "jax"
           else ModelServer(tpool, max_delay_ms=2.0))
    try:
        host, port = srv.serve()
        cls = ServeClient if client == "torch" else JaxClient
        x = np.random.RandomState(5).rand(3, 5).astype(np.float32)
        with cls(host, port, retry_deadline=5.0) as cli:
            assert cli.ping()
            got = cli.infer({"data": x})[0]
            stats = cli.stats()
        want = (tpool if server == "jax" else jpool).run({"data": x})[0]
        np.testing.assert_allclose(got, want, rtol=SERVE_TOL,
                                   atol=SERVE_TOL)
        assert stats["responses"] >= 1
    finally:
        srv.close()
