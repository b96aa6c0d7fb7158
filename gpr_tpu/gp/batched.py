"""Batched many-GP mode: train/predict fleets of small GPs in one program.

The reference processes one GP at a time (a single ``GaussianProcess``
object per dataset); on an accelerator a *batch* of small/medium GPs keeps
the device busy where a single small factorization is latency-bound —
batched Gram GEMMs and one batched Cholesky (SURVEY.md §7 "consider
batched many-small-GP mode").  Use cases: per-window drift
fleets, per-patient models, hyperparameter grids, bootstrap ensembles.

All kernels' hyperparameters may be batched too: pass a kernel pytree whose
leaves carry a leading batch axis (e.g. ``Gaussian(sigmas_of_shape_B,
scales_of_shape_B)``) — everything is ``vmap`` under one ``jit``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..kernels import kernels as kermod
from ..ops import linalg
from ..utils.config import matmul_precision


class BatchedGP(NamedTuple):
    """A fleet of B independent GPs with identical shapes."""

    kernel: Any  # kernel pytree; leaves may carry a leading B axis
    X: jax.Array  # (B, n, d)
    Y: jax.Array  # (B, n, q)
    sigma: jax.Array  # (B,) or scalar
    alpha: jax.Array  # (B, n, q)
    L: jax.Array  # (B, n, n)
    batched_kernel: bool = False


def _kernel_in_axes(kernel, batched: bool):
    # 0 maps every kernel leaf over the batch axis; None broadcasts the
    # whole kernel (an in_axes *tree* would re-construct the kernel class
    # with int leaves and trip parameter validation)
    return 0 if batched else None


def _factor_and_solve(K, Y):
    """Fleet factorization + regression solve: (B, n, n), (B, n, q) ->
    (L, alpha) through XLA's batched Cholesky and triangular solves."""
    L = jnp.linalg.cholesky(K)
    alpha = jax.vmap(lambda l, y: jax.scipy.linalg.cho_solve((l, True), y))(L, Y)
    return L, alpha


def fit_batched(
    kernel,
    X,
    Y,
    sigma,
    jitter: float = 0.0,
    batched_kernel: bool = False,
) -> BatchedGP:
    """Train B GPs at once.  X (B, n, d), Y (B, n, q), sigma scalar or (B,).

    One jitted program: vmapped Gram (a single big batched GEMM), then one
    batched Cholesky and batched triangular solves."""
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 2:
        Y = Y[..., None]
    B, n = X.shape[0], X.shape[1]
    sigma = jnp.broadcast_to(jnp.asarray(sigma, X.dtype), (B,))

    k_axes = _kernel_in_axes(kernel, batched_kernel)

    K = _fleet_gram(kernel, X, sigma**2 + jitter, k_axes)
    L, alpha = _factor_and_solve(K, Y)
    return BatchedGP(
        kernel=kernel, X=X, Y=Y, sigma=sigma, alpha=alpha, L=L,
        batched_kernel=batched_kernel,
    )


def _fleet_gram(kernel, X, noise, k_axes):
    """K[b] + noise[b]*I for the fleet: one vmapped Gram (a batched GEMM
    plus the fused elementwise epilogue)."""

    def gram_one(k, x, nz):
        return linalg.add_diagonal(kermod.gram(k, x), nz)

    return jax.vmap(gram_one, in_axes=(k_axes, 0, 0))(
        kernel, X, jnp.broadcast_to(jnp.asarray(noise, X.dtype), (X.shape[0],))
    )


def predict_batched(gp: BatchedGP, Xs) -> jax.Array:
    """Posterior means: Xs (B, m, d) -> (B, m, q)."""
    Xs = jnp.asarray(Xs)
    k_axes = _kernel_in_axes(gp.kernel, gp.batched_kernel)

    def one(k, xs, x, a):
        Ks = kermod.gram(k, xs, x)
        return jnp.matmul(Ks, a, precision=matmul_precision())

    return jax.vmap(one, in_axes=(k_axes, 0, 0, 0))(gp.kernel, Xs, gp.X, gp.alpha)


def variance_batched(gp: BatchedGP, Xs) -> jax.Array:
    """Diagonal posterior variance: Xs (B, m, d) -> (B, m)."""
    Xs = jnp.asarray(Xs)
    k_axes = _kernel_in_axes(gp.kernel, gp.batched_kernel)

    def one(k, xs, x, L):
        Ks = kermod.gram(k, xs, x)  # (m, n)
        kss = jax.vmap(lambda v: k(v, v))(xs)
        solved = jax.scipy.linalg.cho_solve((L, True), Ks.T)
        return kss - jnp.sum(Ks * solved.T, axis=-1)

    return jax.vmap(one, in_axes=(k_axes, 0, 0, 0))(gp.kernel, Xs, gp.X, gp.L)


def mll_batched(
    kernel, X, Y, sigma, batched_kernel: bool = False,
) -> jax.Array:
    """Per-GP scalar log marginal likelihoods (B,), matching
    ``likelihood.mll_scalar``'s convention per fleet member (datafit summed
    over output dims; complexity and constant counted ONCE) — e.g. for
    scoring a hyperparameter grid in one shot.  Differentiable through
    XLA's batched Cholesky and triangular-solve rules."""
    import math

    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 2:
        Y = Y[..., None]
    B, n = X.shape[0], X.shape[1]
    sigma = jnp.broadcast_to(jnp.asarray(sigma, X.dtype), (B,))
    k_axes = _kernel_in_axes(kernel, batched_kernel)

    def gram_one(k, x, s):
        return linalg.add_diagonal(kermod.gram(k, x), s**2)

    K = jax.vmap(gram_one, in_axes=(k_axes, 0, 0))(kernel, X, sigma)
    L, alpha = _factor_and_solve(K, Y)
    df = -0.5 * jnp.sum(Y * alpha, axis=(1, 2))
    cp = -jnp.sum(jnp.log(jnp.diagonal(L, axis1=1, axis2=2)), axis=1)
    return df + cp - n / 2.0 * math.log(2 * math.pi)


def fit_batched_sharded(
    kernel,
    X,
    Y,
    sigma,
    mesh=None,
    axis: str = "fleet",
    jitter: float = 0.0,
    batched_kernel: bool = False,
) -> BatchedGP:
    """Fleet training with the BATCH axis sharded over a device mesh — the
    expert-parallel analogue for many independent GPs (each device trains
    its shard of models; no collectives needed until results are read).

    ``shard_map`` rather than GSPMD auto-partitioning: each device runs the
    complete per-shard fit locally with zero communication."""
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    if mesh is None:
        mesh = Mesh(np.array(jax.devices()), (axis,))
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 2:
        Y = Y[..., None]
    B = X.shape[0]
    n_dev = mesh.devices.size
    if B % n_dev != 0:
        raise ValueError(f"fleet size ({B}) must be divisible by mesh ({n_dev})")
    sigma = jnp.broadcast_to(jnp.asarray(sigma, X.dtype), (B,))

    sharding = NamedSharding(mesh, P(axis))
    X = jax.device_put(X, NamedSharding(mesh, P(axis, None, None)))
    Y = jax.device_put(Y, NamedSharding(mesh, P(axis, None, None)))
    sigma = jax.device_put(sigma, sharding)
    if batched_kernel:
        kernel = jax.tree_util.tree_map(
            lambda leaf: jax.device_put(jnp.asarray(leaf), sharding), kernel
        )

    k_axes = _kernel_in_axes(kernel, batched_kernel)
    # a single spec acts as a prefix pytree for the whole kernel subtree
    # (a tree_map-built spec tree would re-construct the kernel class with
    # PartitionSpec leaves and trip parameter validation)
    kspec = P(axis) if batched_kernel else P()
    bspec = P(axis, None, None)

    def local_fit(k, x, y, s):
        K = _fleet_gram(k, x, s**2 + jitter, k_axes)
        return _factor_and_solve(K, y)

    fit = jax.jit(
        jax.shard_map(
            local_fit,
            mesh=mesh,
            in_specs=(kspec, bspec, bspec, P(axis)),
            out_specs=(bspec, bspec),
            check_vma=False,
        )
    )
    L, alpha = fit(kernel, X, Y, sigma)
    return BatchedGP(
        kernel=kernel, X=X, Y=Y, sigma=sigma, alpha=alpha, L=L,
        batched_kernel=batched_kernel,
    )


def fit_mle_batched(
    kernel,
    X,
    Y,
    sigma,
    iterations: int = 200,
    learning_rate: float = 0.05,
    log_space: bool = True,
    unroll_chunk: int = 0,
    init=None,
):
    """Per-member MLE over a whole fleet in ONE optimizer loop: every GP
    optimizes its OWN hyperparameters simultaneously (the summed
    ``mll_batched`` objective has block-diagonal structure, so per-member
    gradients never mix), riding the differentiable batched Cholesky.

    The reference optimizes one model per process invocation
    (scripts/main.py loops ``gpLearn`` over studies; ``Optimize`` at
    lib/GaussianProcessInference.cpp works on a single GP) — this is the
    fleet-scale counterpart.

    ``kernel``: a scalar-leaf template (shared init for every member)
    unless ``init`` ((B, P) array, reference param ordering) is given.
    Returns ``(batched_kernel, OptResult)`` with OptResult.params (B, P).
    """
    from ..inference.optimize import OptResult, _run_optax
    from ..kernels import kernels as _kermod
    import optax

    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    B = X.shape[0]
    vec0 = _kermod.params_vector(kernel)
    P = vec0.shape[0]
    if init is None:
        v0 = jnp.broadcast_to(vec0[None, :], (B, P))
    else:
        v0 = jnp.asarray(init, vec0.dtype)
        if v0.shape != (B, P):
            raise ValueError(
                f"fit_mle_batched: init shape {v0.shape} != {(B, P)}"
            )

    def mk_kernel(vecs):
        return kernel.with_params([vecs[:, i] for i in range(P)])

    def objective(vecs):
        if log_space:
            vecs = jnp.exp(vecs)
        kb = mk_kernel(vecs)
        return jnp.sum(
            mll_batched(kb, X, Y, sigma, batched_kernel=True)
        )

    opt = optax.adam(learning_rate)
    x0 = jnp.log(v0) if log_space else v0
    res = _run_optax(objective, x0, opt, iterations, unroll_chunk)
    params = jnp.exp(res.params) if log_space else res.params
    res = OptResult(params=params, value=res.value, trace=res.trace)
    return mk_kernel(params), res
