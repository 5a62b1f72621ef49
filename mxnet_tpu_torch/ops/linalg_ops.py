"""Linear-algebra operators (the counterpart of `mxnet_tpu/ops/linalg_ops.py`;
reference `src/operator/tensor/la_op.h`): ``linalg_gemm``/``gemm2``,
``potrf``, ``potri``, ``trmm``, ``trsm``, ``syrk``, ``gelqf``, ``syevd``,
``sumlogdiag``, ``extractdiag``/``makediag``, ``extracttrian``/
``maketrian``, ``inverse``, ``det`` and ``slogdet``, each also under its
``_linalg_*`` name where the reference registers one.

Every op takes a batch of matrices in its last two axes (``gemm`` and
``gemm2`` in the axes ``axis`` and -1) and runs on `torch.linalg` (cuBLAS
and cuSOLVER on the card, LAPACK on the CPU), with torch's autograd for
the gradients.  The definitions are the JAX package's: ``trmm`` multiplies
by the whole of A as given, ``potri`` reads the lower factor, ``gelqf``
returns (Q, L) and ``syevd`` (U, w) with the eigenvectors in U's rows.
"""
from __future__ import annotations

import torch

from .registry import alias, register


def _t(x):
    return x.transpose(-1, -2)


def _rows_axis(x, attrs):
    """``x`` with its ``axis`` (the rows of the matrices, -2 by default)
    moved to -2."""
    ax = attrs.get_int("axis", -2)
    return x if ax % x.dim() == x.dim() - 2 else torch.movedim(x, ax, -2)


def _rows_back(x, attrs):
    ax = attrs.get_int("axis", -2)
    return x if ax % x.dim() == x.dim() - 2 else torch.movedim(x, -2, ax)


def _product(attrs, A, B):
    a = _rows_axis(A, attrs)
    b = _rows_axis(B, attrs)
    if attrs.get_bool("transpose_a", False):
        a = _t(a)
    if attrs.get_bool("transpose_b", False):
        b = _t(b)
    return attrs.get_float("alpha", 1.0) * (a @ b)


@register("linalg_gemm", num_inputs=3, input_names=["A", "B", "C"])
def _gemm(attrs, A, B, C):
    """alpha op(A) op(B) + beta C."""
    out = _product(attrs, A, B) + attrs.get_float("beta", 1.0) * \
        _rows_axis(C, attrs)
    return _rows_back(out, attrs)


@register("linalg_gemm2", num_inputs=2, input_names=["A", "B"])
def _gemm2(attrs, A, B):
    """alpha op(A) op(B)."""
    return _rows_back(_product(attrs, A, B), attrs)


@register("linalg_potrf", num_inputs=1, input_names=["A"])
def _potrf(attrs, A):
    """The lower Cholesky factor L of A = L L^T, of A's symmetric part
    (A + A^T) / 2, as ``jnp.linalg.cholesky`` takes it: every element of
    A counts, so the gradient is symmetric and equals the central
    differences of this function (LAPACK alone reads the lower
    triangle)."""
    return torch.linalg.cholesky((A + _t(A)) / 2)


def _eye_like(A):
    return torch.eye(A.shape[-1], dtype=A.dtype,
                     device=A.device).expand(A.shape)


@register("linalg_potri", num_inputs=1, input_names=["A"])
def _potri(attrs, A):
    """(L L^T)^-1 from the lower factor L = A."""
    linv = torch.linalg.solve_triangular(A, _eye_like(A), upper=False)
    return _t(linv) @ linv


@register("linalg_trmm", num_inputs=2, input_names=["A", "B"])
def _trmm(attrs, A, B):
    """alpha op(A) B, or alpha B op(A) with ``rightside``."""
    a = _t(A) if attrs.get_bool("transpose", False) else A
    alpha = attrs.get_float("alpha", 1.0)
    return alpha * (B @ a if attrs.get_bool("rightside", False) else a @ B)


@register("linalg_trsm", num_inputs=2, input_names=["A", "B"])
def _trsm(attrs, A, B):
    """X with op(A) X = alpha B (X op(A) = alpha B with ``rightside``), A
    triangular (``lower`` by default)."""
    lower = attrs.get_bool("lower", True)
    a, upper = A, not lower
    if attrs.get_bool("transpose", False):
        a, upper = _t(A), lower
    return torch.linalg.solve_triangular(
        a, attrs.get_float("alpha", 1.0) * B, upper=upper,
        left=not attrs.get_bool("rightside", False))


@register("linalg_sumlogdiag", num_inputs=1, input_names=["A"])
def _sumlogdiag(attrs, A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register("linalg_syrk", num_inputs=1, input_names=["A"])
def _syrk(attrs, A):
    """alpha A A^T (alpha A^T A with ``transpose``)."""
    alpha = attrs.get_float("alpha", 1.0)
    return alpha * (_t(A) @ A if attrs.get_bool("transpose", False)
                    else A @ _t(A))


@register("linalg_gelqf", num_inputs=1, input_names=["A"], num_outputs=2)
def _gelqf(attrs, A):
    """A = L Q with Q's rows orthonormal, as (Q, L) (reference
    `la_op.cc:551`)."""
    q, r = torch.linalg.qr(_t(A))
    return _t(q), _t(r)


@register("linalg_extractdiag", num_inputs=1, input_names=["A"])
def _extractdiag(attrs, A):
    return torch.diagonal(A, offset=attrs.get_int("offset", 0), dim1=-2,
                          dim2=-1)


@register("linalg_makediag", num_inputs=1, input_names=["A"])
def _makediag(attrs, A):
    offset = attrs.get_int("offset", 0)
    return torch.diag_embed(A, offset=offset, dim1=-2, dim2=-1)


def _trian_indices(n, offset, lower, device):
    if lower:
        return torch.tril_indices(n, n, offset, device=device)
    return torch.triu_indices(n, n, offset, device=device)


@register("linalg_extracttrian", num_inputs=1, input_names=["A"])
def _extracttrian(attrs, A):
    """The lower (upper) triangle from diagonal ``offset`` on, packed row
    by row."""
    rows, cols = _trian_indices(A.shape[-1], attrs.get_int("offset", 0),
                                attrs.get_bool("lower", True), A.device)
    return A[..., rows, cols]


@register("linalg_maketrian", num_inputs=1, input_names=["A"])
def _maketrian(attrs, A):
    """The matrix whose packed triangle (`linalg_extracttrian`) is A, with
    zeros elsewhere."""
    offset = attrs.get_int("offset", 0)
    lower = attrs.get_bool("lower", True)
    length = A.shape[-1]
    for n in range(1, length + abs(offset) + 2):
        rows, cols = _trian_indices(n, offset, lower, "cpu")
        if rows.numel() == length:
            break
    else:
        raise ValueError(f"maketrian: packed length {length} matches no "
                         f"matrix size for offset {offset}")
    lin = (rows * n + cols).to(A.device)
    out = A.new_zeros(A.shape[:-1] + (n * n,)).index_copy(-1, lin, A)
    return out.reshape(A.shape[:-1] + (n, n))


@register("linalg_inverse", num_inputs=1, input_names=["A"])
def _inverse(attrs, A):
    return torch.linalg.inv(A)


@register("linalg_det", num_inputs=1, input_names=["A"])
def _det(attrs, A):
    return torch.linalg.det(A)


@register("linalg_slogdet", num_inputs=1, input_names=["A"], num_outputs=2)
def _slogdet(attrs, A):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet


@register("linalg_syevd", num_inputs=1, input_names=["A"], num_outputs=2)
def _syevd(attrs, A):
    """A = U^T diag(w) U for symmetric A, as (U, w), w ascending."""
    w, v = torch.linalg.eigh(A)
    return _t(v), w


for _n in ("gelqf", "gemm", "gemm2", "potrf", "potri", "sumlogdiag",
           "syrk", "trmm", "trsm", "syevd"):
    alias(f"linalg_{_n}", f"_linalg_{_n}")
