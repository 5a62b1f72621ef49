"""Graph and weight interchange between the JAX package and the port:
identical Symbol JSON from one builder, JSON loaded across, shape
inference, and `.params` blobs that round-trip bitwise both ways."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serialization as jser

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.model_zoo import BERT_BASE, bert_encoder
from mxnet_tpu_torch.ndarray.ndarray import NDArray

TINY = dict(num_layers=2, hidden=64, heads=4, ffn=256, vocab=100,
            max_len=128)


@pytest.mark.parametrize("cfg", [TINY, BERT_BASE], ids=["tiny", "base"])
def test_builder_gives_identical_json(cfg):
    assert bert_encoder(mt.sym, **cfg).tojson() == \
        bert_encoder(mx.sym, **cfg).tojson()


# Symbol arithmetic: each expression over variables a and b, and the node
# op it must make in both packages
SUGAR = {
    "add": (lambda a, b: a + b, "broadcast_add"),
    "add_scalar": (lambda a, b: a + 2, "_plus_scalar"),
    "radd_scalar": (lambda a, b: 2 + a, "_plus_scalar"),
    "sub": (lambda a, b: a - b, "broadcast_sub"),
    "sub_scalar": (lambda a, b: a - 0.5, "_minus_scalar"),
    "rsub_scalar": (lambda a, b: 1 - a, "_rminus_scalar"),
    "mul": (lambda a, b: a * b, "broadcast_mul"),
    "mul_scalar": (lambda a, b: a * 0.0, "_mul_scalar"),
    "rmul_scalar": (lambda a, b: 3 * a, "_mul_scalar"),
    "div": (lambda a, b: a / b, "broadcast_div"),
    "div_scalar": (lambda a, b: a / 4, "_div_scalar"),
    "rdiv_scalar": (lambda a, b: 1.5 / a, "_rdiv_scalar"),
    "neg": (lambda a, b: -a, "negative"),
    "chain": (lambda a, b: (a * b + 1.0) / (2 - b), "broadcast_div"),
}


@pytest.mark.parametrize("case", sorted(SUGAR))
def test_arithmetic_sugar_matches_reference(case):
    """The same expression makes the same node ops and the same JSON in
    both packages (auto-name counters reset), and the same values."""
    from mxnet_tpu.symbol import symbol as jsym
    from mxnet_tpu_torch.symbol import symbol as tsym
    expr, op = SUGAR[case]
    syms = []
    saved = [(m, dict(m.counters)) for m in (jsym._NAMES, tsym._NAMES)]
    try:
        for pkg, names in ((mx, jsym._NAMES), (mt, tsym._NAMES)):
            names.counters.clear()
            syms.append(expr(pkg.sym.var("a"), pkg.sym.var("b")))
    finally:
        for m, counters in saved:
            m.counters.clear()
            m.counters.update(counters)
    ref, got = syms
    assert got._heads[0][0].op == op
    assert got.tojson() == ref.tojson()
    rng = np.random.RandomState(3)
    feed = {n: rng.rand(2, 3).astype(np.float32) + 0.5
            for n in got.list_arguments()}
    want = ref.bind(mx.cpu(), args={n: mx.nd.array(v)
                                    for n, v in feed.items()}).forward()
    out = got.bind(mt.cpu(), args={n: mt.nd.array(v, ctx=mt.cpu())
                                   for n, v in feed.items()}).forward()
    np.testing.assert_allclose(out[0].asnumpy(), want[0].asnumpy(),
                               rtol=1e-6, atol=1e-6)


def test_sugar_refuses_what_is_neither_symbol_nor_number():
    with pytest.raises(TypeError):
        mt.sym.var("a") + "b"
    parts = list(mt.sym.SliceChannel(mt.sym.var("x"), num_outputs=3))
    assert [p.list_outputs()[0] for p in parts] == [
        f"{parts[0].name}_output{i}" for i in range(3)]


def test_reference_json_loads_and_round_trips():
    ref = bert_encoder(mx.sym, **TINY)
    loaded = mt.sym.load_json(ref.tojson())
    assert loaded.tojson() == ref.tojson()
    assert loaded.list_arguments() == ref.list_arguments()
    assert loaded.list_outputs() == ref.list_outputs()


@pytest.mark.parametrize("batch,seq", [(2, 128), (3, 64)])
def test_infer_shape_agrees(batch, seq):
    shapes = {"data": (batch, seq), "positions": (1, seq)}
    ref = bert_encoder(mx.sym, **TINY).infer_shape(**shapes)
    got = bert_encoder(mt.sym, **TINY).infer_shape(**shapes)
    assert [tuple(s) for s in got[0]] == [tuple(s) for s in ref[0]]
    assert [tuple(s) for s in got[1]] == [tuple(s) for s in ref[1]]
    assert got[2] == list(ref[2]) == []


def test_infer_shape_partial_leaves_unknowns():
    sym = bert_encoder(mt.sym, **TINY)
    args, outs, _ = sym.infer_shape_partial(positions=(1, 8))
    by_name = dict(zip(sym.list_arguments(), args))
    assert by_name["data"] is None and outs == [None]
    assert by_name["position_embed_weight"] == (128, 64)
    with pytest.raises(mt.MXNetError):
        sym.infer_shape(positions=(1, 8))


# dtypes both packages hold without conversion (the JAX package narrows
# 64-bit arrays with x64 off)
_DTYPES = ["float32", "float16", "bfloat16", "int32", "int8", "uint8",
           "bool"]


def _arrays(seed):
    rng = np.random.RandomState(seed)
    out = {}
    for i, dt in enumerate(_DTYPES):
        shape = [(3, 4), (5,), (), (2, 0, 3), (2, 3, 2), (7,), (4, 2)][i]
        out[f"arg:p{i}_{dt}"] = np.asarray(rng.randn(*shape) * 10,
                                           dtype=np.float32)
    return out


def _to_ref(arrays):
    return {k: mx.nd.array(v, dtype=k.rsplit("_", 1)[1])
            for k, v in arrays.items()}


def _to_port(arrays):
    return {k: NDArray(torch.from_numpy(v).to(getattr(torch,
                                                      k.rsplit("_", 1)[1])))
            for k, v in arrays.items()}


def test_params_blob_round_trips_reference_to_port():
    blob = jser.dumps_ndarrays(_to_ref(_arrays(0)))
    loaded = tser.loads_ndarrays(blob)
    assert list(loaded) == list(_arrays(0))
    assert tser.dumps_ndarrays(loaded) == blob


def test_params_blob_round_trips_port_to_reference():
    blob = tser.dumps_ndarrays(_to_port(_arrays(1)))
    loaded = jser.loads_ndarrays(blob)
    assert jser.dumps_ndarrays(loaded) == blob
    for k, v in tser.loads_ndarrays(blob).items():
        assert np.array_equal(v.asnumpy(),
                              np.asarray(loaded[k].asnumpy(), np.float32)
                              if k.endswith("bfloat16")
                              else loaded[k].asnumpy())


def test_params_footer_is_shared_and_verified():
    payload = tser.dumps_ndarrays(_to_port(_arrays(2)))
    assert tser.make_footer(payload) == jser.make_footer(payload)
    framed = payload + tser.make_footer(payload)
    assert jser.dumps_ndarrays(jser.loads_ndarrays(framed)) == payload
    assert tser.dumps_ndarrays(tser.loads_ndarrays(framed)) == payload
    bad = bytearray(framed)
    bad[40] ^= 0xFF
    with pytest.raises(tser.CheckpointCorruptError):
        tser.loads_ndarrays(bytes(bad))
    with pytest.raises(mt.MXNetError, match="truncated"):
        tser.loads_ndarrays(payload[:-3])


def test_unnamed_params_blob_loads_as_a_list():
    arrays = [mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))]
    loaded = tser.loads_ndarrays(jser.dumps_ndarrays(arrays))
    assert isinstance(loaded, list)
    np.testing.assert_array_equal(loaded[0].asnumpy(), arrays[0].asnumpy())
