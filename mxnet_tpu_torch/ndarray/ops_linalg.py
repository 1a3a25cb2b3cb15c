"""Advanced linear-algebra operators (the la_op family).

The PyTorch counterparts of ``mxnet_tpu/ndarray/ops_linalg.py``
(reference: src/operator/tensor/la_op.cc, la_op-inl.h). Every op works
on the last two axes and broadcasts over the leading batch axes; the
factorizations and solves are ``torch.linalg`` (cuSOLVER and cuBLAS on
the card, LAPACK on the CPU), and the backward is torch's autograd of
them, as the JAX ops' is ``jax.vjp`` of theirs.

Two rules keep the ops capturable in a CUDA graph: the factorizations
that report a failure take their ``_ex`` form with its check off
(``cholesky_ex``, ``inv_ex``: a singular input gives non-finite values,
as the JAX ops do, instead of a host read of the error code), and the
triangle indices of ``extracttrian``/``maketrian`` are made on the
device (``torch.tril_indices``), never copied from the host.
``linalg_syevd`` calls ``torch.linalg.eigh``, whose error check reads
the card's error code on the host; ``tools/op_sweep.py`` lists it as
data-dependent.
"""
from __future__ import annotations

import math

import torch

from .registry import register

__all__ = []


def _tri(A, lower):
    return torch.tril(A) if lower else torch.triu(A)


def _t(x):
    return x.transpose(-1, -2)


# --------------------------------------------------------------- blas3 ---

@register("linalg_gemm")
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2):
    """alpha*op(A)@op(B) + beta*C (reference la_op.cc linalg_gemm);
    ``axis`` names the row axis of the matrices (-2: the plain batched
    case)."""
    if axis != -2:
        A, B, C = (x.movedim(axis, -2) for x in (A, B, C))
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    out = alpha * (a @ b) + beta * C
    return out.movedim(-2, axis) if axis != -2 else out


@register("linalg_gemm2")
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-2):
    """alpha*op(A)@op(B) (reference la_op.cc linalg_gemm2)."""
    if axis != -2:
        A, B = A.movedim(axis, -2), B.movedim(axis, -2)
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    out = alpha * (a @ b)
    return out.movedim(-2, axis) if axis != -2 else out


@register("linalg_syrk")
def linalg_syrk(A, transpose=False, alpha=1.0):
    """alpha*A@Aᵀ (alpha*Aᵀ@A when ``transpose``): la_op.cc linalg_syrk."""
    return alpha * ((_t(A) @ A) if transpose else (A @ _t(A)))


@register("linalg_trmm")
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """alpha*op(tri(A))@B, or alpha*B@op(tri(A)) when ``rightside``
    (reference la_op.cc linalg_trmm)."""
    tri = _tri(A, lower)
    t = _t(tri) if transpose else tri
    return alpha * ((B @ t) if rightside else (t @ B))


@register("linalg_trsm")
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Solve op(tri(A)) @ X = alpha*B, or X @ op(tri(A)) = alpha*B when
    ``rightside`` (reference la_op.cc linalg_trsm); the solve first, then
    the scale, as the JAX op."""
    tri = _tri(A, lower)
    op = _t(tri) if transpose else tri
    # op(A) is upper exactly when A's triangle and the transpose differ
    upper = lower == transpose
    out = torch.linalg.solve_triangular(op, B, upper=upper,
                                        left=not rightside)
    return alpha * out


# ------------------------------------------------------- factorizations ---

@register("linalg_potrf")
def linalg_potrf(A):
    """Lower Cholesky factor L with A = L@Lᵀ (la_op.cc linalg_potrf)."""
    return torch.linalg.cholesky_ex(A, check_errors=False).L


@register("linalg_potri")
def linalg_potri(A):
    """(L@Lᵀ)⁻¹ from the Cholesky factor L that potrf gives (reference
    la_op.cc linalg_potri): L⁻¹ by a triangular solve, then L⁻ᵀ@L⁻¹."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    linv = torch.linalg.solve_triangular(A, eye, upper=False)
    return _t(linv) @ linv


@register("linalg_gelqf")
def linalg_gelqf(A):
    """LQ factorization A = L@Q of a full-row-rank A (m <= n): L lower
    triangular with a positive diagonal, Q's rows orthonormal (la_op.cc
    linalg_gelqf). Through the reduced QR of Aᵀ (Aᵀ = Q₁R₁, so A =
    R₁ᵀQ₁ᵀ), each sign flipped where R₁'s diagonal is negative, as the
    JAX op flips it."""
    q1, r1 = torch.linalg.qr(_t(A), mode="reduced")
    d = torch.diagonal(r1, dim1=-2, dim2=-1)
    s = torch.where(d < 0, -1.0, 1.0).to(A.dtype)
    r1 = r1 * s[..., :, None]
    q1 = q1 * s[..., None, :]
    return _t(r1), _t(q1)


@register("linalg_syevd")
def linalg_syevd(A):
    """Symmetric eigendecomposition (U, L) with A = Uᵀ diag(L) U: U's
    rows are the eigenvectors, L ascending (reference la_op.cc
    linalg_syevd). Each row's sign is LAPACK's or cuSOLVER's choice, in
    either package."""
    w, v = torch.linalg.eigh(A)
    return _t(v), w


@register("linalg_inverse")
def linalg_inverse(A):
    """Matrix inverse (reference la_op.cc _linalg_inverse)."""
    return torch.linalg.inv_ex(A, check_errors=False).inverse


@register("linalg_det")
def linalg_det(A):
    """Determinant (reference la_op.cc _linalg_det)."""
    return torch.linalg.det(A)


@register("linalg_slogdet")
def linalg_slogdet(A):
    """(sign, log|det|) (reference la_op.cc _linalg_slogdet)."""
    sign, logabs = torch.linalg.slogdet(A)
    return sign, logabs


# ------------------------------------------------------------ diagonals ---

@register("linalg_sumlogdiag")
def linalg_sumlogdiag(A):
    """Sum of the log of the diagonal (la_op.cc linalg_sumlogdiag)."""
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register("linalg_extractdiag")
def linalg_extractdiag(A, offset=0):
    """A diagonal as a vector (la_op.cc linalg_extractdiag)."""
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("linalg_makediag")
def linalg_makediag(A, offset=0):
    """Vector -> diagonal matrix, the vector on diagonal ``offset``
    (la_op.cc linalg_makediag)."""
    return torch.diag_embed(A, offset=offset)


def _trian_indices(n, offset, lower, device):
    """The packed row-major triangle's (rows, cols), as the JAX op's
    ``_trian_indices``: the lower (upper) triangle of the (n - |offset|)
    block, shifted down (right) by |offset|."""
    m = n - abs(offset)
    make = torch.tril_indices if lower else torch.triu_indices
    r, c = make(m, m, device=device)
    if lower:
        return r + abs(offset), c
    return r, c + abs(offset)


@register("linalg_extracttrian")
def linalg_extracttrian(A, offset=0, lower=True):
    """A triangle flattened row by row into a vector (la_op.cc
    linalg_extracttrian)."""
    r, c = _trian_indices(A.shape[-1], offset, lower, A.device)
    return A[..., r, c]


@register("linalg_maketrian")
def linalg_maketrian(A, offset=0, lower=True):
    """The inverse of extracttrian: packed vector -> triangular matrix
    (la_op.cc linalg_maketrian); the matrix side from the packed length
    k = m (m + 1) / 2, plus |offset|."""
    k = A.shape[-1]
    m = int((math.sqrt(8 * k + 1) - 1) / 2 + 0.5)
    n = m + abs(offset)
    r, c = _trian_indices(n, offset, lower, A.device)
    # A scattered into the flattened zero matrices, differentiable in A
    flat = A.new_zeros(A.shape[:-1] + (n * n,))
    idx = (r * n + c).expand(A.shape)
    return flat.scatter(-1, idx, A).reshape(A.shape[:-1] + (n, n))
