"""The port's `linalg` ops (`ops/linalg_ops.py`, `nd.linalg`,
`sym.linalg`) against the JAX package on the CPU, past the sweep's cases
(`tests/test_torch_op_sweep.py`): leading batch axes of rank 2, the
factorizations' identities, gradients of potrf, potri, trsm, syevd and
gelqf through each package's autograd, and a symbol graph of linalg ops
through both packages' executors.  Tolerance 1e-5 of the reference's
largest magnitude (LAPACK on both sides); TF32 plays no part on the
CPU."""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = 1e-5
RS = np.random.RandomState(11)
A4 = RS.randn(2, 2, 3, 3).astype(np.float32)
SPD4 = (A4 @ np.swapaxes(A4, -1, -2) + 3 * np.eye(3)).astype(np.float32)
L4 = np.linalg.cholesky(SPD4.astype(np.float64)).astype(np.float32)
B4 = RS.randn(2, 2, 3, 4).astype(np.float32)
W4 = RS.randn(2, 2, 3, 5).astype(np.float32)


def _close(t, j, what):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape, what
    assert np.abs(t - j).max() <= TOL * np.abs(j).max(), what


def _grads(pkg, name, inputs, attrs, weights):
    nd = pkg.nd
    arrs = [nd.array(x) for x in inputs]
    for a in arrs:
        a.attach_grad()
    with pkg.autograd.record():
        outs = getattr(nd.linalg, name)(*arrs, **attrs)
        outs = outs if isinstance(outs, list) else [outs]
        head = None
        for o, w in zip(outs, weights):
            if w is None:
                continue
            term = (o * nd.array(w)).sum()
            head = term if head is None else head + term
    head.backward()
    return [o.asnumpy() for o in outs], [a.grad.asnumpy() for a in arrs]


GRAD_CASES = {
    "potrf": ([SPD4], {}, lambda o: [RS.randn(*o[0].shape)]),
    "potri": ([L4], {}, lambda o: [RS.randn(*o[0].shape)]),
    "trsm": ([L4, B4], {"alpha": 0.5}, lambda o: [RS.randn(*o[0].shape)]),
    "trsm_transpose": ([L4, B4], {"transpose": True},
                       lambda o: [RS.randn(*o[0].shape)]),
    # eigenvalues only: each eigenvector is defined up to its sign
    "syevd": ([SPD4], {}, lambda o: [None, RS.randn(*o[1].shape)]),
    "gelqf": ([B4], {}, lambda o: [RS.randn(*o[0].shape),
                                   RS.randn(*o[1].shape)]),
    "sumlogdiag": ([SPD4], {}, lambda o: [RS.randn(*o[0].shape)]),
    "inverse": ([SPD4], {}, lambda o: [RS.randn(*o[0].shape)]),
    "det": ([SPD4], {}, lambda o: [RS.randn(*o[0].shape)]),
    "slogdet": ([SPD4], {}, lambda o: [None, RS.randn(*o[1].shape)]),
    "gemm": ([B4, W4, RS.randn(2, 2, 4, 5).astype(np.float32)],
             {"transpose_a": True, "alpha": 2.0, "beta": 0.5},
             lambda o: [RS.randn(*o[0].shape)]),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_batched_gradients_match_reference(case):
    name = case.split("_")[0]
    inputs, attrs, make_w = GRAD_CASES[case]
    with mt.cpu():
        probe = getattr(mt.nd.linalg, name)(*[mt.nd.array(x)
                                               for x in inputs], **attrs)
    probe = probe if isinstance(probe, list) else [probe]
    weights = [None if w is None else w.astype(np.float32)
               for w in make_w([p.asnumpy() for p in probe])]
    j_out, j_grad = _grads(mx, name, inputs, attrs, weights)
    with mt.cpu():
        t_out, t_grad = _grads(mt, name, inputs, attrs, weights)
    for k, (t, j, w) in enumerate(zip(t_out, j_out, weights)):
        if w is not None:
            _close(t, j, f"{case} output {k}")
    for i, (t, j) in enumerate(zip(t_grad, j_grad)):
        _close(t, j, f"{case} gradient wrt input {i}")


def test_factorizations_reconstruct_their_input():
    with mt.cpu():
        L = mt.nd.linalg.potrf(mt.nd.array(SPD4)).asnumpy()
        np.testing.assert_allclose(L @ np.swapaxes(L, -1, -2), SPD4,
                                   rtol=1e-5, atol=1e-5)
        inv = mt.nd.linalg.potri(mt.nd.array(L)).asnumpy()
        np.testing.assert_allclose(inv @ SPD4, np.broadcast_to(np.eye(3),
                                                               SPD4.shape),
                                   atol=1e-5)
        Q, Lq = (o.asnumpy() for o in mt.nd.linalg.gelqf(mt.nd.array(B4)))
        np.testing.assert_allclose(Lq @ Q, B4, atol=1e-5)
        np.testing.assert_allclose(Q @ np.swapaxes(Q, -1, -2),
                                   np.broadcast_to(np.eye(3), (2, 2, 3, 3)),
                                   atol=1e-5)
        U, w = (o.asnumpy() for o in mt.nd.linalg.syevd(mt.nd.array(SPD4)))
        rec = np.swapaxes(U, -1, -2) @ (w[..., None] * U)
        np.testing.assert_allclose(rec, SPD4, rtol=1e-5, atol=1e-4)


def test_namespaces_match_reference():
    assert sorted(mt.nd.linalg.__all__) == sorted(mx.nd.linalg.__all__)
    assert sorted(mt.sym.linalg.__all__) == sorted(mx.sym.linalg.__all__)
    for n in ("gemm", "gemm2", "potrf", "potri", "trmm", "trsm", "syrk",
              "gelqf", "syevd", "sumlogdiag"):
        assert f"_linalg_{n}" in dir(mt.nd)


def test_symbol_graph_matches_reference():
    """syrk -> potrf -> sumlogdiag (half the log-determinant of A A^T + I)
    bound and run through both packages' executors."""
    a = RS.randn(3, 4).astype(np.float32)

    def run(pkg, ctx):
        x = pkg.sym.var("a")
        eye = pkg.sym.var("eye")
        s = pkg.sym.linalg.sumlogdiag(pkg.sym.linalg.potrf(
            pkg.sym.linalg.syrk(x) + eye))
        ex = s.bind(ctx, args={"a": pkg.nd.array(a, ctx=ctx),
                               "eye": pkg.nd.array(np.eye(3), ctx=ctx)},
                    args_grad={"a": pkg.nd.zeros((3, 4), ctx=ctx),
                               "eye": pkg.nd.zeros((3, 3), ctx=ctx)})
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward([pkg.nd.ones(out.shape, ctx=ctx)])
        return out, ex.grad_dict["a"].asnumpy()

    (jo, jg), (to, tg) = run(mx, mx.cpu()), run(mt, mt.cpu())
    _close(to, jo, "forward")
    _close(tg, jg, "gradient")
    ref = 0.5 * np.linalg.slogdet(a.astype(np.float64) @ a.T + np.eye(3))[1]
    np.testing.assert_allclose(to, ref, rtol=1e-5)
