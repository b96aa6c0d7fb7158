"""Batched many-GP fleet tests: agreement with per-GP fits, batched
hyperparameters, grid scoring."""

import math

import numpy as np
import jax.numpy as jnp
import pytest

import gpr_tpu
from gpr_tpu.gp import batched, exact
from gpr_tpu.gp import likelihood as lk


def test_mll_batched_grad_matches_stock_path():
    """The fleet MLL's gradient (one batched Cholesky under jax.grad) must
    equal the sum of the per-member ``likelihood.mll_scalar`` gradients —
    the dense single-GP path, member by member."""
    import jax

    rng = np.random.default_rng(3)
    B, n, d = 3, 64, 3
    X = jnp.asarray(rng.standard_normal((B, n, d)))
    Y = jnp.asarray(np.sin(np.asarray(X).sum(-1, keepdims=True)))

    def fleet(p):
        return jnp.sum(batched.mll_batched(gpr_tpu.Gaussian(p[0], p[1]), X, Y, 0.2))

    def members(p):
        k = gpr_tpu.Gaussian(p[0], p[1])
        return sum(lk.mll_scalar(k, X[b], Y[b], 0.2) for b in range(B))

    p0 = jnp.asarray([1.7, 0.9])
    v_fleet, g_fleet = jax.value_and_grad(fleet)(p0)
    v_ref, g_ref = jax.value_and_grad(members)(p0)
    np.testing.assert_allclose(float(v_fleet), float(v_ref), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(g_fleet), np.asarray(g_ref), rtol=1e-8)


def test_fit_mle_batched_recovers_per_member_params():
    """Fleet-scale MLE: two members with DIFFERENT true lengthscales must
    move toward their own optima in one optimizer loop (the summed
    objective is block-diagonal in the per-member parameters)."""
    import jax

    rng = np.random.default_rng(5)
    B, n, d = 2, 64, 1
    X = jnp.asarray(rng.uniform(0, 6, (B, n, d)).astype(np.float32))
    sig_true = np.array([0.6, 2.5], np.float32)
    Y = jnp.asarray(np.stack([
        np.sin(np.asarray(X[b, :, 0]) * 2.0 / sig_true[b])[:, None]
        for b in range(B)
    ]).astype(np.float32))

    k0 = gpr_tpu.Gaussian(jnp.asarray(1.2), jnp.asarray(1.0))
    kb, res = batched.fit_mle_batched(
        k0, X, Y, 0.1, iterations=60, learning_rate=0.1
    )
    assert res.params.shape == (B, 2)
    m0 = batched.mll_batched(
        gpr_tpu.Gaussian(jnp.full((B,), 1.2), jnp.full((B,), 1.0)),
        X, Y, 0.1, batched_kernel=True,
    )
    m1 = batched.mll_batched(kb, X, Y, 0.1, batched_kernel=True)
    # every member's own mll improved, and the two members diverged
    assert np.all(np.asarray(m1) > np.asarray(m0))
    s = np.asarray(res.params)[:, 0]
    assert abs(s[0] - s[1]) > 0.1


def _fleet(B=4, n=30, d=2, q=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, n, d))
    Y = np.sin(X.sum(-1, keepdims=True)) + 0.05 * rng.standard_normal((B, n, q))
    return jnp.asarray(X), jnp.asarray(Y)


class TestBatchedFit:
    def test_matches_individual_fits(self):
        X, Y = _fleet()
        k = gpr_tpu.Gaussian(1.2, 0.9)
        fleet = batched.fit_batched(k, X, Y, sigma=0.1)
        for b in range(X.shape[0]):
            gp = exact.fit(k, X[b], Y[b], sigma=0.1)
            np.testing.assert_allclose(
                np.asarray(fleet.alpha[b]), np.asarray(gp.alpha), atol=1e-8
            )

    def test_predict_and_variance(self):
        X, Y = _fleet()
        k = gpr_tpu.Gaussian(1.2, 0.9)
        fleet = batched.fit_batched(k, X, Y, sigma=0.1)
        Xs = X[:, :5]
        mean = batched.predict_batched(fleet, Xs)
        var = batched.variance_batched(fleet, Xs)
        assert mean.shape == (4, 5, 2)
        assert var.shape == (4, 5)
        gp0 = exact.fit(k, X[0], Y[0], sigma=0.1)
        np.testing.assert_allclose(
            np.asarray(mean[0]), np.asarray(gp0.predict(Xs[0])), atol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(var[0]), np.asarray(gp0.posterior_var(Xs[0])), atol=1e-8
        )

    def test_per_gp_sigma(self):
        X, Y = _fleet(B=3)
        k = gpr_tpu.Gaussian(1.0, 1.0)
        sigmas = jnp.asarray([0.01, 0.1, 1.0])
        fleet = batched.fit_batched(k, X, Y, sigma=sigmas)
        gp1 = exact.fit(k, X[1], Y[1], sigma=0.1)
        np.testing.assert_allclose(
            np.asarray(fleet.alpha[1]), np.asarray(gp1.alpha), atol=1e-8
        )

    def test_batched_hyperparameters_grid(self):
        """A hyperparameter grid scored in ONE program: kernel leaves carry
        the batch axis."""
        rng = np.random.default_rng(1)
        x = np.linspace(0, 6, 40)
        y = np.sin(x) + 0.1 * rng.standard_normal(40)
        B = 8
        sigmas = jnp.asarray(np.geomspace(0.2, 5.0, B))
        kgrid = gpr_tpu.Gaussian(sigmas, jnp.ones(B))
        X = jnp.broadcast_to(jnp.asarray(x)[None, :, None], (B, 40, 1))
        Y = jnp.broadcast_to(jnp.asarray(y)[None, :, None], (B, 40, 1))
        mlls = batched.mll_batched(kgrid, X, Y, sigma=0.1, batched_kernel=True)
        assert mlls.shape == (B,)
        # cross-check one entry against the dense likelihood
        ref = float(lk.mll_scalar(gpr_tpu.Gaussian(float(sigmas[3]), 1.0), x, y, 0.1))
        np.testing.assert_allclose(float(mlls[3]), ref, rtol=1e-10)
        # the best lengthscale is interior, not an endpoint
        best = int(np.argmax(np.asarray(mlls)))
        assert 0 < best < B - 1


def test_fleet_sharded_over_mesh():
    """The fleet's batch axis sharded over 8 devices (EP analogue):
    results match the single-device fleet, outputs stay sharded."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    X, Y = _fleet(B=16, n=24)
    k = gpr_tpu.Gaussian(1.2, 0.9)
    fleet = batched.fit_batched_sharded(k, X, Y, sigma=0.1)
    ref = batched.fit_batched(k, X, Y, sigma=0.1)
    np.testing.assert_allclose(
        np.asarray(fleet.alpha), np.asarray(ref.alpha), atol=1e-10
    )
    assert "fleet" in str(fleet.alpha.sharding)


def test_fleet_sharded_indivisible_rejected():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    X, Y = _fleet(B=6, n=10)
    with pytest.raises(ValueError):
        batched.fit_batched_sharded(gpr_tpu.Gaussian(1.0), X, Y, sigma=0.1)


def test_mll_batched_multioutput_matches_scalar():
    """mll_batched at q>1 follows likelihood.mll_scalar's convention
    (datafit summed over outputs; complexity + constant once)."""
    rng = np.random.default_rng(9)
    X = rng.standard_normal((3, 40, 2))
    Y = np.sin(X.sum(-1, keepdims=True)) + np.stack(
        [np.zeros((3, 40)), 0.1 * rng.standard_normal((3, 40))], axis=-1
    )[..., 0:2] * 0 + rng.standard_normal((3, 40, 2)) * 0.1
    k = gpr_tpu.Gaussian(1.1, 0.9)
    got = batched.mll_batched(k, jnp.asarray(X), jnp.asarray(Y), sigma=0.2)
    for b in range(3):
        ref = float(lk.mll_scalar(k, X[b], Y[b], 0.2))
        np.testing.assert_allclose(float(got[b]), ref, rtol=1e-10)


def test_mll_batched_grad():
    """mll_batched must stay differentiable by default (hyperparameter
    optimization is its primary use)."""
    import jax

    X, Y = _fleet(B=2, n=20)

    def obj(log_sigma):
        k = gpr_tpu.Gaussian(jnp.exp(log_sigma), 1.0)
        return jnp.sum(batched.mll_batched(k, X, Y, sigma=0.1))

    g = jax.grad(obj)(jnp.asarray(0.3))
    assert bool(jnp.isfinite(g))
