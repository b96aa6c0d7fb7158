"""Distributed Gram + Cholesky + solve over a device mesh (block rows).

The scale-out for the GP's n axis (SURVEY.md §5.7: "sharding the Gram
matrix and Cholesky across chips — block-row distribution").
The reference's only n-axis story is OpenMP threads on one host
(lib/GaussianProcess.cpp:384-402); here n=16k+ Gram rows are sharded over a
1-D mesh and the factorization proceeds panel-by-panel with
collectives:

  for each device-block column k (static loop, D iterations):
    1. all_gather the column block C = K[:, k]           (n x nb)
    2. every device redundantly factors the diagonal block and forms the
       panel  P = C_below chol(C_kk)^-T                  (O(n nb^2), 3/D
       redundancy — the trailing update dominates)
    3. local trailing update  K_local -= P_local P_right^T  (pure GEMM,
       perfectly parallel — this is ~n^3/3 total flops)

The forward/backward substitutions broadcast each solved row-block with a
psum-mask (owner computes, psum replicates).  All collectives are inserted
by shard_map over the mesh axis; XLA hands them to NCCL on GPUs.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..kernels import kernels as kermod
from ..ops.blocked import cholesky_blocked, solve_triangular_blocked
from ..utils.config import matmul_precision


def default_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def sharded_gram(kernel, X, mesh: Mesh, axis: str = "data") -> jax.Array:
    """K with rows sharded over ``axis``.  X replicated in (it is (n, d)
    with small d — the O(n^2) K is what must not be replicated)."""
    n = X.shape[0]
    D = mesh.shape[axis]
    if n % D != 0:
        raise ValueError(f"n ({n}) must be divisible by mesh axis size ({D})")

    def shard_fn(X_local, X_full):
        return kermod.gram(kernel, X_local, X_full)

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis, None), P(None, None)),
        out_specs=P(axis, None),
    )(X, X)


def _chol_panels(K_local, *, axis: str, D: int, nb: int):
    """SPMD body: block-row distributed right-looking Cholesky.

    K_local: (nb, n) — this device's rows.  Returns L_local (nb, n).

    Owner-rows schedule (round 4; the round-3 version all_gathered the RAW
    column block and every device solved the FULL below-panel — O(n nb^2)
    replicated work): each device solves only its OWN (nb, nb) row block
    against Lkk, then the SOLVED panel is all_gathered for the trailing
    update.  Per panel: one (nb, nb) psum (diagonal block broadcast) + one
    (n, nb) all_gather (same volume as the old raw-column gather).
    Replicated flops drop to the (nb^3)/3 diagonal factorization; the
    (n, nb) gathered buffer itself is inherent to a right-looking
    trailing update (every device needs all solved rows below k)."""
    my = lax.axis_index(axis)
    panels = []
    A = K_local
    for k in range(D):
        C_local = A[:, k * nb : (k + 1) * nb]  # (nb, nb) own rows, col k
        # diagonal block: owner's rows, replicated via masked psum
        Ckk = lax.psum(
            jnp.where(my == k, C_local, jnp.zeros_like(C_local)), axis
        )
        Lkk = cholesky_blocked(Ckk)  # (nb, nb), replicated O(nb^3/3)
        # own rows of the panel: C_local Lkk^-T (valid below the diagonal;
        # masked to Lkk on the owner and zeros above)
        solved = solve_triangular_blocked(Lkk, C_local.T).T
        panel_local = jnp.where(
            my == k, Lkk, jnp.where(my > k, solved, jnp.zeros_like(solved))
        )
        panels.append(panel_local)
        # trailing update on local rows, remaining columns only
        if k + 1 < D:
            panel = lax.all_gather(panel_local, axis, tiled=True)  # (n, nb)
            right = panel[(k + 1) * nb :, :]  # (n - (k+1) nb, nb)
            upd = jnp.matmul(
                panel_local, right.T, preferred_element_type=A.dtype,
                precision=matmul_precision(),
            )
            A = A.at[:, (k + 1) * nb :].add(-upd)
    return jnp.concatenate(panels, axis=1)  # (nb, n)


def cholesky_sharded(K: jax.Array, mesh: Mesh, axis: str = "data") -> jax.Array:
    """Distributed lower Cholesky; K and L row-sharded over ``axis``."""
    n = K.shape[0]
    D = mesh.shape[axis]
    nb = n // D
    return jax.shard_map(
        partial(_chol_panels, axis=axis, D=D, nb=nb),
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=P(axis, None),
    )(K)


def _add_diag_sharded(K: jax.Array, val, mesh: Mesh, axis: str) -> jax.Array:
    """K + val * I for a row-sharded K (masked add at global offsets)."""

    def f(K_local, v):
        my = lax.axis_index(axis)
        nb, n = K_local.shape
        row = lax.broadcasted_iota(jnp.int32, (nb, n), 0) + my * nb
        col = lax.broadcasted_iota(jnp.int32, (nb, n), 1)
        return K_local + jnp.where(row == col, v.astype(K_local.dtype), 0.0)

    return jax.shard_map(
        f, mesh=mesh, in_specs=(P(axis, None), P()), out_specs=P(axis, None)
    )(K, jnp.asarray(val, K.dtype))


def _diag_mean_sharded(K: jax.Array, mesh: Mesh, axis: str) -> jax.Array:
    def f(K_local):
        my = lax.axis_index(axis)
        nb = K_local.shape[0]
        blk = lax.dynamic_slice_in_dim(K_local, my * nb, nb, axis=1)
        return lax.psum(jnp.sum(jnp.abs(jnp.diagonal(blk))), axis)[None]

    tot = jax.shard_map(
        f, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis)
    )(K)
    return tot[0] / K.shape[0]


def safe_cholesky_sharded(
    K: jax.Array, mesh: Mesh, axis: str = "data",
    initial_jitter: float = 0.0, max_tries: int = 6,
):
    """Distributed :func:`gpr_tpu.ops.linalg.safe_cholesky`: jitter
    escalation around the row-sharded factorization so a near-singular
    K + sigma^2 I recovers exactly like the single-device path instead of
    silently returning a NaN factor.  Returns (L row-sharded, jitter)."""
    dtype = K.dtype
    eps = jnp.finfo(dtype).eps
    L0 = cholesky_sharded(K, mesh, axis)
    # NaN from a failed pivot propagates through every later panel's
    # trailing update, across devices — the global last pivot detects it
    ok0 = jnp.isfinite(L0[-1, -1])
    ij = jnp.asarray(initial_jitter, dtype)

    def cond(st):
        ok, tries, _, _ = st
        return jnp.logical_and(jnp.logical_not(ok), tries < max_tries)

    def body(st):
        _, tries, j, _ = st
        dm = _diag_mean_sharded(K, mesh, axis)
        base = jnp.where(ij > 0, ij, eps * jnp.maximum(dm, 1.0)).astype(dtype)
        jnew = jnp.where(tries == 0, base, j * 10.0)
        Lnew = cholesky_sharded(
            _add_diag_sharded(K, jnew, mesh, axis), mesh, axis
        )
        return jnp.isfinite(Lnew[-1, -1]), tries + 1, jnew, Lnew

    j0 = jnp.zeros((), dtype) + jnp.asarray(ok0, dtype) * 0
    _, _, j, L = lax.while_loop(
        cond, body, (ok0, jnp.asarray(0, jnp.int32), j0, L0)
    )
    return L, j


def _forward_solve(L_local, B, *, axis: str, D: int, nb: int):
    """L Y = B with L row-sharded, B replicated -> Y replicated.
    Owner-computes + psum-broadcast per block row."""
    my = lax.axis_index(axis)
    q = B.shape[1]
    Y = jnp.zeros_like(B)
    for k in range(D):
        Lkk = L_local[:, k * nb : (k + 1) * nb]
        rhs = B[k * nb : (k + 1) * nb]
        if k > 0:
            left = L_local[:, : k * nb]  # (nb, k nb)
            rhs = rhs - jnp.matmul(
                left, Y[: k * nb], preferred_element_type=B.dtype,
                precision=matmul_precision(),
            )
        yk = solve_triangular_blocked(Lkk, rhs)
        yk = jnp.where(my == k, yk, jnp.zeros_like(yk))
        yk = lax.psum(yk, axis)  # broadcast the owner's block
        Y = Y.at[k * nb : (k + 1) * nb].set(yk)
    return Y


def _backward_solve(L_local, Ymid, *, axis: str, D: int, nb: int):
    """L^T X = Y with L row-sharded (so L^T is column-sharded): iterate
    block rows bottom-up; owner k holds L[k nb:(k+1) nb, :] i.e. column
    block k of L^T."""
    my = lax.axis_index(axis)
    X = jnp.zeros_like(Ymid)
    for k in reversed(range(D)):
        # X_k = Lkk^-T (Y_k - sum_{j>k} L^T[k, j] X_j); L^T[k, j] = L[j nb.., k nb..]^T
        # owner of L rows j>k contributes; assemble via psum of partial sums
        Lk_cols = L_local[:, k * nb : (k + 1) * nb]  # (nb, nb) = L[my rows, k cols]
        partial_contrib = jnp.where(
            my > k,
            jnp.matmul(
                Lk_cols.T,
                lax.dynamic_slice_in_dim(X, my * nb, nb, axis=0),
                preferred_element_type=X.dtype,
                precision=matmul_precision(),
            ),
            jnp.zeros((nb, X.shape[1]), X.dtype),
        )
        s = lax.psum(partial_contrib, axis)
        rhs = Ymid[k * nb : (k + 1) * nb] - s
        Lkk = jnp.where(my == k, Lk_cols, jnp.eye(nb, dtype=X.dtype))
        xk = solve_triangular_blocked(Lkk.T, rhs, lower=False)
        xk = jnp.where(my == k, xk, jnp.zeros_like(xk))
        xk = lax.psum(xk, axis)
        X = X.at[k * nb : (k + 1) * nb].set(xk)
    return X


def cho_solve_sharded(
    L: jax.Array, B: jax.Array, mesh: Mesh, axis: str = "data"
) -> jax.Array:
    """Solve (L L^T) X = B with L row-sharded, B/X replicated."""
    n = L.shape[0]
    D = mesh.shape[axis]
    nb = n // D

    def body(L_local, B):
        Y = _forward_solve(L_local, B, axis=axis, D=D, nb=nb)
        return _backward_solve(L_local, Y, axis=axis, D=D, nb=nb)

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis, None), P(None, None)),
        out_specs=P(None, None),
    )(L, B)


def fit_sharded(
    kernel, X, Y, sigma, mesh: Mesh, axis: str = "data"
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Distributed GP fit: (alpha replicated, logdet, L row-sharded).

    The multi-chip analogue of gp.fit for n beyond one chip's HBM
    (north-star n=16k+, BASELINE.json)."""
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    K = sharded_gram(kernel, X, mesh, axis)

    def add_noise(K_local):
        my = lax.axis_index(axis)
        n = K_local.shape[1]
        nb = K_local.shape[0]
        row = jax.lax.broadcasted_iota(jnp.int32, (nb, n), 0) + my * nb
        col = jax.lax.broadcasted_iota(jnp.int32, (nb, n), 1)
        return K_local + jnp.where(
            row == col, jnp.asarray(sigma, K_local.dtype) ** 2, 0.0
        )

    K = jax.shard_map(
        add_noise, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis, None)
    )(K)
    L, _ = safe_cholesky_sharded(K, mesh, axis)
    alpha = cho_solve_sharded(L, Y, mesh, axis)

    def local_logdet(L_local):
        my = lax.axis_index(axis)
        nb = L_local.shape[0]
        diag_block = lax.dynamic_slice_in_dim(L_local, my * nb, nb, axis=1)
        return lax.psum(
            2.0 * jnp.sum(jnp.log(jnp.diagonal(diag_block))), axis
        )[None]

    logdet = jax.shard_map(
        local_logdet, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis)
    )(L)
    return alpha, logdet[0], L
