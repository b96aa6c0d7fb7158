"""Hyperparameter point-estimate inference (MLE / MAP).

Covers the reference's ``GaussianProcessInference`` optimizer (reference
include/GaussianProcessInference.h:40-243) with two implementations:

1. :class:`GaussNewtonInference` — faithful re-derivation of the reference's
   pinv-based, log-damped Gauss-Newton scheme (``Optimize`` /
   ``Optimize2``), including per-parameter freeze masks.  Exists so the
   reference's optimization-trajectory tests (MaximumLikelihoodTest2,
   MaximumAPosterioriTest) can be reproduced.
2. :func:`fit_mle` / :func:`fit_map` — the accelerator path: jitted
   value-and-grad of the (log-)posterior over log-hyperparameters, driven by
   optax Adam (or scipy-free L-BFGS via optax).

MAP objective = weighted log-likelihood + sum of prior log-pdfs
(reference tests/MaximumAPosterioriTest.cpp:126-183 builds exactly this).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import optax

from ..gp import likelihood as lk
from ..kernels import kernels as kermod
from ..ops import linalg


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

def make_mll_objective(kernel, X, Y, sigma):
    """Objective(vec) -> scalar log marginal likelihood at params ``vec``
    (reference GaussianLogLikelihood)."""

    def f(vec):
        return lk.mll_scalar(kernel.with_params(list(vec)), X, Y, sigma)

    return f


def make_map_objective(kernel, X, Y, sigma, priors: Sequence, weight: float = 1.0):
    """Objective = weight * MLL + sum_p log prior_p(theta_p)
    (reference tests/MaximumAPosterioriTest.cpp:136-169: weighted
    log-likelihood plus log-prior derivatives).  ``priors[i]`` may be None
    to leave parameter i unregularized."""

    def f(vec):
        val = weight * lk.mll_scalar(kernel.with_params(list(vec)), X, Y, sigma)
        for i, prior in enumerate(priors):
            if prior is not None:
                val = val + prior.log_pdf(vec[i])
        return val

    return f


def make_log_objective(kernel, X, Y, sigma, priors=None, weight: float = 1.0):
    """Objective over LOG-hyperparameters: vec = log(theta).  This is the
    production parameterization (positivity by construction; the reference
    achieves the same with the log-parameterized GaussianExpKernel,
    include/Kernel.h:569-676)."""

    def f(log_vec):
        vec = jnp.exp(log_vec)
        val = weight * lk.mll_scalar(kernel.with_params(list(vec)), X, Y, sigma)
        if priors is not None:
            for i, prior in enumerate(priors):
                if prior is not None:
                    val = val + prior.log_pdf(vec[i])
        return val

    return f


# ---------------------------------------------------------------------------
# accelerator optimizer path
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OptResult:
    params: jax.Array  # optimized hyperparameters (natural space)
    value: float  # final objective value
    trace: jax.Array  # objective per iteration


def _run_optax(
    objective: Callable,
    x0: jax.Array,
    optimizer,
    iterations: int,
    unroll_chunk: int = 0,
) -> OptResult:
    """Optax loop.  ``unroll_chunk > 0`` replaces the ``lax.scan`` with
    python-unrolled jitted chunks (at most two compiled programs), for
    when a scan over a step whose body holds a full MLL
    factorization+gradient compiles slowly (same contract as
    ``hmc.sample_hmc_chunked``)."""
    vg = jax.value_and_grad(lambda v: -objective(v))

    def step(carry, _):
        x, opt_state = carry
        loss, g = vg(x)
        g = jnp.where(jnp.isfinite(g), g, 0.0)
        updates, opt_state = optimizer.update(g, opt_state, x)
        x = optax.apply_updates(x, updates)
        return (x, opt_state), loss

    if unroll_chunk > 0:
        chunk = max(1, min(unroll_chunk, iterations))

        def make(length):
            @jax.jit
            def run(x, opt_state):
                losses = []
                for _ in range(length):
                    (x, opt_state), loss = step((x, opt_state), None)
                    losses.append(loss)
                return x, opt_state, jnp.stack(losses)

            return run

        n_full, rem = divmod(iterations, chunk)
        run_chunk = make(chunk)
        x, st = x0, optimizer.init(x0)
        parts = []
        for _ in range(n_full):
            x, st, ls = run_chunk(x, st)
            parts.append(ls)
        if rem:
            x, st, ls = make(rem)(x, st)
            parts.append(ls)
        # iterations=0 runs no chunks; match the scan path's empty trace
        losses = (
            jnp.concatenate(parts) if parts else jnp.zeros((0,), x0.dtype)
        )
    else:
        (x, _), losses = jax.lax.scan(
            jax.jit(step), (x0, optimizer.init(x0)), None, length=iterations
        )
    # losses[-1] was evaluated BEFORE the final update; report the
    # objective at the RETURNED parameters so value and params correspond
    final = float(objective(x))
    return OptResult(params=x, value=final, trace=-losses)


def fit_mle(
    kernel,
    X,
    Y,
    sigma,
    iterations: int = 200,
    learning_rate: float = 0.05,
    log_space: bool = True,
    unroll_chunk: int = 0,
):
    """Maximize the log marginal likelihood; returns (kernel*, OptResult).

    ``unroll_chunk > 0`` runs the loop as python-unrolled jitted chunks
    (see :func:`_run_optax`)."""
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    vec0 = kermod.params_vector(kernel)
    opt = optax.adam(learning_rate)
    if log_space:
        obj = make_log_objective(kernel, X, Y, sigma)
        res = _run_optax(obj, jnp.log(vec0), opt, iterations, unroll_chunk)
        params = jnp.exp(res.params)
    else:
        obj = make_mll_objective(kernel, X, Y, sigma)
        res = _run_optax(obj, vec0, opt, iterations, unroll_chunk)
        params = res.params
    res = OptResult(params=params, value=res.value, trace=res.trace)
    return kernel.with_params(list(params)), res


def fit_map(
    kernel,
    X,
    Y,
    sigma,
    priors: Sequence,
    weight: float = 1.0,
    iterations: int = 200,
    learning_rate: float = 0.05,
    log_space: bool = True,
    unroll_chunk: int = 0,
):
    """Maximize the (weighted) log posterior; returns (kernel*, OptResult).

    The MAP workflow of reference tests/MaximumAPosterioriTest.cpp:126-183.
    ``unroll_chunk``: see :func:`fit_mle`."""
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    vec0 = kermod.params_vector(kernel)
    opt = optax.adam(learning_rate)
    if log_space:
        obj = make_log_objective(kernel, X, Y, sigma, priors=priors, weight=weight)
        res = _run_optax(obj, jnp.log(vec0), opt, iterations, unroll_chunk)
        params = jnp.exp(res.params)
    else:
        obj = make_map_objective(kernel, X, Y, sigma, priors, weight)
        res = _run_optax(obj, vec0, opt, iterations, unroll_chunk)
        params = res.params
    res = OptResult(params=params, value=res.value, trace=res.trace)
    return kernel.with_params(list(params)), res


# ---------------------------------------------------------------------------
# reference-compatible Gauss-Newton scheme
# ---------------------------------------------------------------------------

class GaussNewtonInference:
    """Re-derivation of the reference's iterative scheme
    (include/GaussianProcessInference.h:84-229).

    ``optimize``  — the reference's ``Optimize``: update direction
        pinv(g g^T) g scaled by the likelihood value, log-damped step sizes,
        sign handling, falling back to a log gradient step when the
        pseudo-inverse annihilates a coordinate.
    ``optimize2`` — the reference's ``Optimize2``: Jacobian-based
        pinv(J^T J) J^T |l| updates with per-parameter freeze mask and
        early-exit when the likelihood stops moving.
    """

    def __init__(
        self,
        objective_value_and_grad: Callable,
        params0: Sequence[float],
        step_width: float,
        iterations: int,
        objective_value_and_jacobian: Optional[Callable] = None,
    ):
        self._vg = objective_value_and_grad
        self._vj = objective_value_and_jacobian
        self.params = jnp.asarray(params0, jnp.result_type(float))
        self.step = step_width
        self.step3 = step_width**3
        self.iterations = iterations
        self.mask = jnp.ones(self.params.shape, bool)

    def set_parameters_to_optimize(self, mask: Sequence[bool]):
        m = list(self.mask)
        for i, v in enumerate(mask[: len(m)]):
            m[i] = bool(v)
        self.mask = jnp.asarray(m)

    def optimize(self, verbose: bool = False):
        import numpy as np

        for it in range(self.iterations):
            try:
                value, grad = self._vg(self.params)
            except (ValueError, FloatingPointError) as e:
                if verbose:
                    print(f"[failed] {e}")
                return self.params
            value = np.asarray(value).reshape(-1)
            grad = np.asarray(grad).reshape(-1)
            if not np.all(np.isfinite(grad)) or not np.all(np.isfinite(value)):
                return self.params
            sign = -1.0 if value[0] > 0 else 1.0
            gg = np.outer(grad, grad)
            update = np.asarray(linalg.pinv(jnp.asarray(gg))) @ grad
            p = np.array(self.params, dtype=float)
            for i in range(p.size):
                if not bool(self.mask[i]):
                    continue
                if update[i] == 0:  # log gradient step
                    u = self.step3 * np.log1p(abs(grad[i]))
                    u = u if grad[i] >= 0 else -u
                    p[i] += u * sign
                else:  # Gauss-Newton step
                    u = update[i] * value[0]
                    u = self.step * np.log1p(u) if u > 0 else -self.step * np.log1p(abs(u))
                    p[i] -= u * sign
            self.params = jnp.asarray(p)
            if verbose:
                print(f"iter {it}: value={value}, params={p}")
        return self.params

    def optimize2(self, verbose: bool = False):
        import numpy as np

        if self._vj is None:
            raise ValueError("optimize2 requires a value-and-jacobian objective")
        old = None
        for it in range(self.iterations):
            try:
                value, J = self._vj(self.params)
            except (ValueError, FloatingPointError) as e:
                if verbose:
                    print(f"[failed] {e}")
                return self.params
            value = np.asarray(value).reshape(-1)
            J = np.asarray(J)
            # the reference compares the PREVIOUS transformed vector (-|l|,
            # stored at the end of the last iteration) against the RAW
            # current one (GaussianProcessInference.h:171-176) — for
            # positive likelihood values it therefore never early-exits
            if old is not None and np.linalg.norm(old - value) == 0:
                break
            # sign loop (GaussianProcessInference.h:178-181): every entry
            # becomes NON-positive (-|l|), which sets the update direction
            neg_value = -np.abs(value)
            JtJ = J.T @ J
            update = (np.asarray(linalg.pinv(jnp.asarray(JtJ))) @ J.T) @ neg_value
            p = np.array(self.params, dtype=float)
            for i in range(p.size):
                if not bool(self.mask[i]):
                    continue
                if update[i] > 0:
                    p[i] -= self.step * np.log1p(update[i])
                else:
                    p[i] += self.step * np.log1p(abs(update[i]))
            self.params = jnp.asarray(p)
            old = neg_value
            if verbose:
                print(f"iter {it}: value={value}, params={p}")
        return self.params


def reference_objective(kernel, X, Y, sigma, priors=None, weight: float = 1.0,
                        exp_params: bool = False):
    """(value_and_grad, value_and_jacobian) callables for
    :class:`GaussNewtonInference` over the reference's natural-parameter
    vector.  With ``exp_params=True`` the optimizer works in log space and
    parameters are exponentiated before entering the kernel (the trick used
    throughout reference MaximumAPosterioriTest with GaussianExpKernel)."""

    def to_nat(vec):
        return jnp.exp(vec) if exp_params else vec

    def vg(vec):
        nat = to_nat(jnp.asarray(vec))
        k = kernel.with_params(list(nat))
        value, grad = lk.mll_value_and_grad(k, X, Y, sigma)
        value = weight * value
        grad = weight * grad
        if priors is not None:
            for i, prior in enumerate(priors):
                if prior is not None:
                    value = value + prior.log_pdf(nat[i])
                    grad = grad.at[i].add(prior.log_derivative(nat[i]))
        if exp_params:
            grad = grad * nat  # chain rule d/dlog
        return value, grad

    def vj(vec):
        nat = to_nat(jnp.asarray(vec))
        k = kernel.with_params(list(nat))
        value, J = lk.mll_jacobian(k, X, Y, sigma)
        value = weight * value
        J = weight * J
        if priors is not None:
            for i, prior in enumerate(priors):
                if prior is not None:
                    value = value + prior.log_pdf(nat[i])
                    J = J.at[:, i].add(prior.log_derivative(nat[i]))
        if exp_params:
            J = J * nat[None, :]
        return value, J

    return vg, vj
