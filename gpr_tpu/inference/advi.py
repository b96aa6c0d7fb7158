"""Mean-field ADVI over GP hyperparameters — the VI leg of the
BASELINE.json north star ("hyperparameter inference runs as JAX/Pallas
NUTS/HMC and VI instead of L-BFGS point estimates"; the reference's
GaussianProcessInference is a pinv Gauss-Newton point estimator,
include/GaussianProcessInference.h:84-229).

q(z) = N(mu, diag(sigma^2)) over the UNCONSTRAINED parameters z (the
same log-parameterization the samplers use, so ``make_gp_log_posterior``
targets drop in unchanged).  The ELBO is maximized by stochastic
gradient ascent with the reparameterization trick:

    ELBO(mu, omega) = E_{eps~N(0,I)}[ logp(mu + exp(omega) * eps) ]
                      + sum(omega) + dim/2 * log(2 pi e)

(the entropy of a diagonal Gaussian; constants kept so the reported
ELBO is comparable across dims).  One jitted optax loop; the Monte
Carlo expectation vmaps ``num_samples`` draws per step, so each step
is a single batched gram+Cholesky program on the device — the same
compute shape as ``num_samples`` HMC chains.

Compared to the samplers: ADVI gives calibrated-mean, mean-field
(diagonal) posteriors in a fixed number of steps with no warmup or
step-size adaptation — the cheap first look; HMC/NUTS remain the
reference-quality posterior.  ``ADVIResult.sample`` draws from q for
predictive averaging via ``inference.predictive``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class ADVIResult(NamedTuple):
    mean: jax.Array        # (dim,) posterior mean of z
    std: jax.Array         # (dim,) posterior std of z
    elbo: jax.Array        # final ELBO estimate (scalar)
    elbo_trace: jax.Array  # (num_steps,) per-step ELBO estimates

    def sample(self, key, num_samples: int = 1) -> jax.Array:
        """Draw (num_samples, dim) from q — e.g. for Bayesian model
        averaging via ``predictive_from_samples``."""
        eps = jax.random.normal(
            key, (num_samples, self.mean.shape[0]), self.mean.dtype
        )
        return self.mean[None, :] + self.std[None, :] * eps


def fit_advi(
    logp_fn: Callable,
    z0,
    key,
    num_steps: int = 400,
    num_samples: int = 8,
    learning_rate: float = 0.05,
    init_log_std: float = -2.0,
) -> ADVIResult:
    """Fit q(z) = N(mu, diag(sigma^2)) to ``exp(logp_fn)`` by maximizing
    the reparameterized ELBO.

    ``logp_fn(z) -> scalar`` is the unnormalized log posterior on the
    unconstrained space (``hmc.make_gp_log_posterior`` /
    ``make_sparse_gp_log_posterior`` work as-is).  ``z0`` (dim,) seeds
    the variational mean (a MAP/MLE point estimate is a good seed).
    The whole optimization is ONE ``lax.scan`` under jit (the scan body
    is a plain gradient update, not a sampler transition, and compiles
    quickly)."""
    import optax

    z0 = jnp.atleast_1d(jnp.asarray(z0))
    dim = z0.shape[0]
    dtype = z0.dtype
    ent_const = 0.5 * dim * math.log(2.0 * math.pi * math.e)

    def neg_elbo(params, key):
        mu, omega = params
        eps = jax.random.normal(key, (num_samples, dim), dtype)
        zs = mu[None, :] + jnp.exp(omega)[None, :] * eps
        lp = jnp.mean(jax.vmap(logp_fn)(zs))
        return -(lp + jnp.sum(omega) + ent_const)

    # cosine-decayed step size: the reparameterized gradient is noisy
    # (num_samples MC draws), so a fixed step leaves the mean jittering
    # at an lr-proportional stationary noise floor; annealing to ~0
    # converges the variational parameters themselves
    opt = optax.adam(optax.cosine_decay_schedule(learning_rate, num_steps))
    params0 = (z0, jnp.full((dim,), init_log_std, dtype))
    keys = jax.random.split(key, num_steps)

    @jax.jit
    def run(params0, keys):
        state0 = opt.init(params0)

        def step(carry, k):
            params, state = carry
            loss, grads = jax.value_and_grad(neg_elbo)(params, k)
            updates, state = opt.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            return (params, state), -loss

        (params, _), elbos = jax.lax.scan(step, (params0, state0), keys)
        return params, elbos

    (mu, omega), elbos = run(params0, keys)
    return ADVIResult(
        mean=mu, std=jnp.exp(omega), elbo=elbos[-1], elbo_trace=elbos
    )
