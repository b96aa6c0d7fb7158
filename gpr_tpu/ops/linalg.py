"""PSD-safe linear algebra primitives.

This is the replacement for the reference's L0 numerics backend
(reference: include/LAPACKUtils.h — LAPACK dgetrf/dgetri/dpotrf/dpotri
bindings, and lib/GaussianProcess.cpp:530-618 — four explicit-inverse
strategies).  The single biggest deliberate design difference from the
reference: we never form explicit inverses.  Everything is expressed as a
Cholesky factorization + triangular solves, which is both numerically
superior and maps onto large GEMMs and the vendor solver libraries.

Key entry points
----------------
``safe_cholesky``    Cholesky with automatic jitter escalation (mirrors the
                     defensive guards at reference lib/GaussianProcess.cpp:
                     398-401 and SparseGaussianProcess.h:174-180).
``cho_solve``        Solve ``A x = b`` given the factor.
``solve_psd``        One-shot factor+solve.
``logdet_from_chol`` log|A| = 2·Σ log diag(L), with the reference's
                     determinant under/overflow clamping semantics
                     (reference include/Likelihood.h:180-188) translated to
                     log space.
``inv_psd``          Explicit inverse (only for parity tests / the saved
                     CoreMatrix artifact, never on the hot path).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax


# log-space clamping bounds, mirroring the reference's clamping of the
# determinant to [min, max] of LONG DOUBLE (include/Likelihood.h:180-188).
# The bounds are the reference's, NOT the compute dtype's: log|A| is a sum
# of logs and comfortably representable in f32 far beyond f32's own
# log-range (+-88), which would otherwise clamp (and zero the gradient of)
# the MLL complexity term for every realistic n in float32.
_LDBL_LOG_MAX = 11356.523406294143  # log(LDBL_MAX), 80-bit extended


def _logdet_bounds(dtype) -> Tuple[float, float]:
    del dtype
    return -_LDBL_LOG_MAX, _LDBL_LOG_MAX


def add_diagonal(A: jax.Array, value) -> jax.Array:
    """A + value * I as a fusible masked add.

    ``value`` may be a scalar or batched (matching A's batch dims).  The
    obvious ``A.at[idx, idx].add(v)`` lowers to an unfused copy + scatter;
    the iota-mask form is a single fusible elementwise pass XLA can sink
    into the consumer (the Gram epilogue)."""
    n = A.shape[-1]
    rows = lax.broadcasted_iota(jnp.int32, (n, n), 0)
    cols = lax.broadcasted_iota(jnp.int32, (n, n), 1)
    value = jnp.asarray(value, A.dtype)
    if value.ndim:
        value = value[..., None, None]  # broadcast batch values across the diagonal
    return A + jnp.where(rows == cols, value, jnp.zeros((), A.dtype))


# size from which single large matrices take the recursive blocked
# Cholesky and solves (ops/blocked.py) instead of one stock call.  On the
# H100 one cuSOLVER potrf measured faster (PERF.md); changing the route is
# ROADMAP Speed item 1
_BLOCKED_MIN_N = 1024


def chol_lower(A: jax.Array) -> jax.Array:
    """Lower Cholesky factor, dispatching to the blocked kernel for large
    single matrices (batched inputs use the stock primitive)."""
    if A.ndim == 2 and A.shape[0] >= _BLOCKED_MIN_N:
        from .blocked import cholesky_blocked

        return cholesky_blocked(A)
    return jnp.linalg.cholesky(A)


def _mT(X: jax.Array) -> jax.Array:
    return jnp.swapaxes(X, -1, -2)


def _tri_solve(L: jax.Array, B: jax.Array, *, trans: bool) -> jax.Array:
    """Solve ``L X = B`` (trans=False) or ``L^T X = B`` (trans=True) for
    lower-triangular L, dispatching to the blocked solver for large 2D."""
    if L.ndim == 2 and L.shape[0] >= _BLOCKED_MIN_N:
        from .blocked import solve_triangular_blocked

        if trans:
            return solve_triangular_blocked(L.T, B, lower=False)
        return solve_triangular_blocked(L, B, lower=True)
    return jax.scipy.linalg.solve_triangular(L, B, lower=True, trans=1 if trans else 0)


def _chol_pullback(L: jax.Array, Lbar: jax.Array) -> jax.Array:
    """Reverse-mode pullback of the Cholesky map A -> L computed directly
    from the factor (Murray 2016, "Differentiation of the Cholesky
    decomposition"): Abar = L^{-T} phi(L^T Lbar) L^{-1} with phi = tril,
    diagonal halved.  One GEMM + two triangular solves, matching the cost
    of XLA's native rule while staying expressible with the blocked
    solves for large n."""
    from ..utils.config import matmul_precision

    n = L.shape[-1]
    M = jnp.matmul(_mT(L), jnp.tril(Lbar), precision=matmul_precision())
    M = jnp.tril(M) * (1.0 - 0.5 * jnp.eye(n, dtype=L.dtype))
    P = _tri_solve(L, M, trans=True)  # L^{-T} M
    # P L^{-1} = (L^{-T} P^T)^T
    Abar = _mT(_tri_solve(L, _mT(P), trans=True))
    # XLA's native rule returns the symmetrized cotangent (the input is
    # treated as symmetric); match it exactly
    return 0.5 * (Abar + _mT(Abar))


def _diag_ok(L):
    # NaN/inf from a failed pivot propagates (via the column scaling and
    # trailing updates — only *, -, /, sqrt are involved) to EVERY later
    # diagonal entry, so the last one alone detects failure: an O(1)
    # check instead of an O(n) strided diagonal gather over the factor.
    return jnp.all(jnp.isfinite(L[..., -1, -1]))


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _safe_cholesky_impl(A, initial_jitter, max_tries):
    dtype = A.dtype
    eps = jnp.finfo(dtype).eps
    batch_shape = A.shape[:-2]

    # Large single matrices: factor to the UNASSEMBLED block tree and carry
    # THAT through the retry loop — a while_loop carry of the assembled
    # factor forces the concat-assembly tree to materialize; assembling
    # once after the loop lets XLA elide or fuse the concats into the
    # consumers/outputs.
    if A.ndim == 2 and A.shape[0] >= _BLOCKED_MIN_N:
        from .blocked import assemble_blocks, cholesky_blocked_blocks, last_leaf

        factor = cholesky_blocked_blocks
        ok_of = lambda b: jnp.isfinite(last_leaf(b)[-1, -1])
        finish = assemble_blocks
    else:
        factor = chol_lower
        # PER-ELEMENT success for batched inputs: one failing fleet member
        # must not force escalating jitter onto every other member's
        # factor (it would distort an MLL grid around one singular point
        # and falsely report jitter for elements that factored cleanly)
        ok_of = lambda L: jnp.isfinite(L[..., -1, -1])
        finish = lambda L: L

    # one factorization attempt; this is the whole success path
    L0 = factor(A)
    ok0 = ok_of(L0)

    def _keep(ok, old, new):
        # broadcast the per-element ok over trailing matrix dims
        mask = jnp.reshape(ok, ok.shape + (1,) * (new.ndim - ok.ndim))
        return jnp.where(mask, old, new)

    def cond(state):
        ok, tries, _, _ = state
        return jnp.logical_and(
            jnp.logical_not(jnp.all(ok)), tries < max_tries
        )

    def body(state):
        ok, tries, j, L = state
        # jitter scale from a HEAD SLICE of the diagonal: the full-diagonal
        # gather is loop-invariant, so XLA hoists it out of the retry loop
        # and the SUCCESS path pays it too (a strided gather over the whole
        # matrix).  The mean over the first
        # <=1024 diagonal entries is an equally good scale heuristic (the
        # reference uses a *fixed* jitter, SparseGaussianProcess.h:174-180)
        # and its hoisted cost is microseconds.
        h = min(A.shape[-1], 1024)
        diag_mean = jnp.mean(
            jnp.abs(jnp.diagonal(A[..., :h, :h], axis1=-2, axis2=-1)),
            axis=-1,
        )
        base = jnp.broadcast_to(
            jnp.where(
                initial_jitter > 0,
                initial_jitter.astype(dtype),
                eps * jnp.maximum(diag_mean, 1.0),
            ),
            batch_shape,
        ).astype(dtype)
        # escalate ONLY the failed elements; succeeded ones keep their
        # jitter and factor untouched
        jesc = jnp.where(tries == 0, base, j * 10.0)
        jnew = jnp.where(ok, j, jesc) if ok.ndim else jesc
        Lraw = factor(add_diagonal(A, jnew))
        Lnew = jax.tree_util.tree_map(
            lambda old, new: _keep(ok, old, new), L, Lraw
        ) if ok.ndim else Lraw
        return jnp.logical_or(ok, ok_of(Lnew)), tries + 1, jnew, Lnew

    # The FACTOR itself is a loop carry: on success the loop runs zero
    # iterations and returns (L0, 0) with the carry buffer aliased to L0 —
    # no branch-boundary copy.  (A lax.cond formulation makes XLA
    # materialize the branch outputs into fresh buffers even when the
    # taken branch is the identity on L0.)
    # Derive the jitter init from ok0 rather than a fresh constant: under
    # shard_map a constant carry is axis-UNvarying while the body output
    # varies over the manual axes, which while_loop rejects.
    j0 = jnp.zeros(batch_shape, dtype) + jnp.asarray(ok0, dtype) * 0
    _, _, j, L = lax.while_loop(
        cond, body, (ok0, jnp.asarray(0, jnp.int32), j0, L0)
    )
    return finish(L), j


def _safe_cholesky_fwd(A, initial_jitter, max_tries):
    out = _safe_cholesky_impl(A, initial_jitter, max_tries)
    return out, out[0]


def _safe_cholesky_bwd(max_tries, L, cts):
    # Pullback from the RETURNED factor: L = chol(A + j(A) I) with j
    # piecewise-constant in A, so dL/dA is the Cholesky jacobian at the
    # jittered point — computable from L alone (Murray 2016).  Masked to
    # exactly zero when even the max jitter failed (NaN factor): XLA's
    # native VJP at a NaN primal poisons gradients even for zero cotangent.
    Lbar, _ = cts
    ok = jnp.all(jnp.isfinite(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
    okb = ok[..., None, None]
    n = L.shape[-1]
    Lsafe = jnp.where(okb, L, jnp.eye(n, dtype=L.dtype))
    Abar = _chol_pullback(Lsafe, jnp.where(okb, Lbar, jnp.zeros_like(Lbar)))
    Abar = jnp.where(okb, Abar, jnp.zeros_like(Abar))
    # the chosen jitter is treated as a constant of the data (its
    # derivative is zero a.e.); initial_jitter gets no cotangent either
    return Abar, jnp.zeros((), L.dtype)


_safe_cholesky_impl.defvjp(_safe_cholesky_fwd, _safe_cholesky_bwd)


def safe_cholesky(
    A: jax.Array,
    initial_jitter: float = 0.0,
    max_tries: int = 6,
) -> Tuple[jax.Array, jax.Array]:
    """Cholesky with jitter escalation.

    Attempts ``chol(A + j*I)`` with ``j`` escalating from ``initial_jitter``
    (or eps-scaled if 0) by 10x per retry until the factorization succeeds.
    Returns ``(L, jitter_used)``.  Fully jittable.

    This replaces the reference's strategy of falling back between LAPACK LU
    / Cholesky / SVD / eigendecomposition (lib/GaussianProcess.cpp:530-618).

    The success path executes exactly ONE Cholesky and NO extra HBM pass
    over the factor: the bare factor is checked via its last diagonal entry
    (a failed pivot propagates NaN to every later one) and the retry loop —
    which carries the factor, so its zero-iteration result aliases the
    attempt — only runs on failure.  The whole function is a ``custom_vjp``
    primitive differentiated via the Cholesky pullback of the *returned*
    factor (reverse-mode AD cannot cross ``lax.while_loop``, and the chosen
    jitter is piecewise-constant in ``A``, so the pullback at the jittered
    point is the exact gradient).
    """
    return _safe_cholesky_impl(
        A, jnp.asarray(initial_jitter, A.dtype), int(max_tries)
    )


def cho_solve(L: jax.Array, b: jax.Array) -> jax.Array:
    """Solve A x = b where A = L L^T (blocked solves for large factors)."""
    if L.ndim == 2 and L.shape[0] >= _BLOCKED_MIN_N:
        from .blocked import cho_solve_blocked

        return cho_solve_blocked(L, b)
    y = jax.scipy.linalg.solve_triangular(L, b, lower=True)
    return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)


def solve_psd(A: jax.Array, b: jax.Array, jitter: float = 0.0) -> jax.Array:
    L, _ = safe_cholesky(A, initial_jitter=jitter)
    return cho_solve(L, b)


def logdet_from_chol(L: jax.Array) -> jax.Array:
    """log|A| from its Cholesky factor, clamped like the reference clamps
    the determinant (include/Likelihood.h:180-188), translated to log space."""
    lo, hi = _logdet_bounds(L.dtype)
    ld = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
    return jnp.clip(ld, lo, hi)


def inv_psd(A: jax.Array, jitter: float = 0.0) -> jax.Array:
    """Explicit PSD inverse.  Kept for parity with the reference's saved
    CoreMatrix artifact (lib/GaussianProcess.cpp:152-153) and the
    InversionMethodsTest semantics — NOT used on the hot path."""
    L, _ = safe_cholesky(A, initial_jitter=jitter)
    eye = jnp.eye(A.shape[-1], dtype=A.dtype)
    return cho_solve(L, eye)


def pinv(A: jax.Array, epsilon: float | None = None) -> jax.Array:
    """SVD-based Moore-Penrose pseudo-inverse matching the reference's
    ``gpr::pinv`` (include/Prior.h:38-56): singular values <= epsilon are
    zeroed (not inverted)."""
    if epsilon is None:
        epsilon = float(jnp.finfo(jnp.float64).eps) if A.dtype == jnp.float64 else float(jnp.finfo(A.dtype).eps)
    U, s, Vh = jnp.linalg.svd(A, full_matrices=True)
    s_inv = jnp.where(s <= epsilon, 0.0, 1.0 / jnp.where(s <= epsilon, 1.0, s))
    k = s.shape[0]
    from ..utils.config import matmul_precision

    return jnp.matmul(
        Vh.T[:, :k] * s_inv[None, :], U.T[:k, :], precision=matmul_precision()
    )


def symmetrize(A: jax.Array) -> jax.Array:
    return 0.5 * (A + jnp.swapaxes(A, -1, -2))
