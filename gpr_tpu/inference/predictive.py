"""Posterior-predictive GP: predictions marginalized over hyperparameter
draws.

The reason the rebuild samples hyperparameters (HMC/NUTS) instead of point-
estimating them (the reference's Gauss-Newton) is this module: the
predictive distribution

    p(y* | X, Y) = E_{theta ~ p(theta | X, Y)} [ N(mean_theta, var_theta) ]

is a mixture over posterior draws — mean = E[mean_s], variance =
E[var_s + mean_s^2] - mean^2.  Each draw's fit+predict runs as one vmapped
program over a (subsampled) batch of draws: the batched Gram + batched
Cholesky run on the device together (gp/batched.py machinery)."""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..kernels import kernels as kermod
from ..ops import linalg
from ..utils.config import matmul_precision


class PredictiveResult(NamedTuple):
    mean: jax.Array  # (m, q)
    variance: jax.Array  # (m,) marginal predictive variance (incl. noise)
    mean_per_draw: jax.Array  # (S, m, q)
    variance_per_draw: jax.Array  # (S, m)


def subsample_draws(samples: jax.Array, num: int) -> jax.Array:
    """Thin (chains, T, dim) posterior draws to ``num`` evenly spaced
    parameter vectors (num, dim), in NATURAL space."""
    z = jnp.asarray(samples).reshape(-1, samples.shape[-1])
    idx = jnp.linspace(0, z.shape[0] - 1, num).astype(jnp.int32)
    return jnp.exp(z[idx])


def predictive(
    kernel,
    theta_draws: jax.Array,
    X,
    Y,
    Xs,
    sigma,
    include_noise: bool = True,
) -> PredictiveResult:
    """Mixture predictive over hyperparameter draws.

    ``theta_draws`` (S, p) in natural space and reference ordering (e.g.
    from :func:`subsample_draws`); ``sigma`` is the observation-noise std
    (scalar, or (S,) if it was sampled too)."""
    X = jnp.asarray(X)
    if X.ndim == 1:
        X = X[:, None]
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    Xs = jnp.asarray(Xs)
    if Xs.ndim == 1:
        Xs = Xs[:, None]
    S = theta_draws.shape[0]
    sigmas = jnp.broadcast_to(jnp.asarray(sigma, X.dtype), (S,))

    def one(theta, s):
        k = kernel.with_params(list(theta))
        K = kermod.gram(k, X)
        K = linalg.add_diagonal(K, s**2)
        # jitter-escalating factorization: posterior draws can land on
        # ill-conditioned kernels (huge lengthscales -> near-rank-1 K)
        L, _ = linalg.safe_cholesky(K)
        alpha = jax.scipy.linalg.cho_solve((L, True), Y)
        Ks = kermod.gram(k, Xs, X)
        mean = jnp.matmul(Ks, alpha, precision=matmul_precision())
        kss = jax.vmap(lambda v: k(v, v))(Xs)
        solved = jax.scipy.linalg.cho_solve((L, True), Ks.T)
        var = kss - jnp.sum(Ks * solved.T, axis=-1)
        if include_noise:
            var = var + s**2
        return mean, jnp.maximum(var, 0.0)

    means, variances = jax.vmap(one)(theta_draws, sigmas)  # (S, m, q), (S, m)

    mix_mean = jnp.mean(means, axis=0)  # (m, q)
    # total variance = E[var] + Var over draws of the (first-output) mean
    mean_sq = jnp.mean(jnp.sum(means**2, axis=-1) / means.shape[-1], axis=0)
    mix_sq = jnp.sum(mix_mean**2, axis=-1) / means.shape[-1]
    mix_var = jnp.mean(variances, axis=0) + jnp.maximum(mean_sq - mix_sq, 0.0)
    return PredictiveResult(
        mean=mix_mean,
        variance=mix_var,
        mean_per_draw=means,
        variance_per_draw=variances,
    )


def predictive_from_hmc(
    kernel, result, X, Y, Xs, sigma, num_draws: int = 32, include_noise: bool = True
) -> PredictiveResult:
    """Convenience: thin an :class:`hmc.HMCResult`/:class:`nuts.NUTSResult`
    and compute the mixture predictive."""
    theta = subsample_draws(result.samples, num_draws)
    return predictive(kernel, theta, X, Y, Xs, sigma, include_noise)


def predictive_sharded(
    kernel,
    theta_draws: jax.Array,
    X,
    Y,
    Xs,
    sigma,
    mesh=None,
    axis: str = "draws",
    include_noise: bool = True,
) -> PredictiveResult:
    """Mixture predictive with the DRAW axis sharded over a device mesh —
    each chip fits/predicts its shard of posterior draws, the mixture
    moments combine with psum means (embarrassingly parallel; one
    collective pair at the end)."""
    import numpy as np
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P

    if mesh is None:
        devs = jax.devices()
        mesh = Mesh(np.array(devs), (axis,))
    S = theta_draws.shape[0]
    n_dev = mesh.devices.size
    if S % n_dev != 0:
        raise ValueError(
            f"num draws ({S}) must be divisible by mesh size ({n_dev})"
        )
    sigmas = jnp.broadcast_to(
        jnp.asarray(sigma, jnp.asarray(X).dtype), (S,)
    )

    def shard_fn(theta_local, sigma_local):
        res = predictive(
            kernel, theta_local, X, Y, Xs, sigma_local, include_noise
        )
        # combine mixture moments across shards
        mean = lax.pmean(jnp.mean(res.mean_per_draw, axis=0), axis)
        e_var = lax.pmean(jnp.mean(res.variance_per_draw, axis=0), axis)
        q = res.mean_per_draw.shape[-1]
        e_msq = lax.pmean(
            jnp.mean(jnp.sum(res.mean_per_draw**2, axis=-1) / q, axis=0), axis
        )
        var = e_var + jnp.maximum(e_msq - jnp.sum(mean**2, axis=-1) / q, 0.0)
        return mean, var, res.mean_per_draw, res.variance_per_draw

    mean, var, mpd, vpd = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(), P(), P(axis, None, None), P(axis, None)),
        check_vma=False,
    )(theta_draws, sigmas)
    return PredictiveResult(
        mean=mean, variance=var, mean_per_draw=mpd, variance_per_draw=vpd
    )
