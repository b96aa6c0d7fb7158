"""The plain-XLA route of the exact GP against float64 numpy: the Gram of
every stationary and periodic kernel family, ``gpr_tpu.fit`` through the
blocked recursion at aligned and non-aligned n, ``safe_cholesky`` and
``cho_solve`` on the large-matrix route, and the fleet fit and MLL
gradient against per-member fits."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla

import gpr_tpu
from gpr_tpu.gp import batched
from gpr_tpu.gp import likelihood as lk
from gpr_tpu.kernels import kernels as kermod
from gpr_tpu.ops import linalg


def _r2(A, B):
    return ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)


def _matern(nu2):
    def k(A, B, sigma, scale):
        a = math.sqrt(nu2) * np.sqrt(_r2(A, B)) / sigma
        poly = {1: 1.0, 3: 1.0 + a, 5: 1.0 + a + a * a / 3.0}[nu2]
        return scale**2 * poly * np.exp(-a)

    return k


# family -> (kernel object, float64 numpy Gram by direct differences)
FAMILIES = {
    "gaussian": (
        kermod.Gaussian(1.3, 0.8),
        lambda A, B: 0.8**2 * np.exp(-0.5 * _r2(A, B) / 1.3**2),
    ),
    "gaussian_exp": (
        kermod.GaussianExp(math.log(1.3), math.log(0.8)),
        lambda A, B: 0.8**2 * np.exp(-0.5 * _r2(A, B) / 1.3**2),
    ),
    "rational_quadratic": (
        kermod.RationalQuadratic(0.8, 1.1, 1.7),
        lambda A, B: 0.8**2 * (1 + _r2(A, B) / (2 * 1.7 * 1.1**2)) ** -1.7,
    ),
    "matern12": (
        kermod.Matern12(1.2, 0.9),
        lambda A, B: _matern(1)(A, B, 1.2, 0.9),
    ),
    "matern32": (
        kermod.Matern32(1.2, 0.9),
        lambda A, B: _matern(3)(A, B, 1.2, 0.9),
    ),
    "matern52": (
        kermod.Matern52(1.2, 0.9),
        lambda A, B: _matern(5)(A, B, 1.2, 0.9),
    ),
    "periodic": (
        kermod.Periodic(0.9, 1.7, 1.1),
        lambda A, B: 0.9**2 * np.exp(
            -0.5
            * (np.sin(1.7 * (A[:, None, :] - B[None, :, :])) ** 2).sum(-1)
            / 1.1**2
        ),
    ),
}


def _inputs(n, d=3, seed=0):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, (n, d))


@pytest.mark.parametrize("n", [7, 512, 700])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_gram_matches_float64_direct(family, n):
    """The GEMM identity |x|^2 + |y|^2 - 2 x.y carries an absolute error of
    ~eps |x|^2 into r^2; the Matern forms take sqrt(r^2), which turns it
    into ~sqrt(eps) |x| at coincident points, hence their wider bound."""
    kernel, ref = FAMILIES[family]
    atol = 1e-7 if family.startswith("matern") else 1e-12
    X = _inputs(n, seed=n)
    Y = _inputs(n // 2 + 1, seed=n + 1)
    K = np.asarray(kermod.gram(kernel, jnp.asarray(X), jnp.asarray(Y)))
    assert K.shape == (n, n // 2 + 1)
    np.testing.assert_allclose(K, ref(X, Y), rtol=0, atol=atol)
    Ks = np.asarray(kermod.gram(kernel, jnp.asarray(X)))
    np.testing.assert_allclose(Ks, ref(X, X), rtol=0, atol=atol)


@pytest.mark.parametrize("n", [1024, 1200])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fit_matches_float64_solve(family, n):
    """``gpr_tpu.fit`` from n=1024 takes the blocked recursion; 1200 is
    not a multiple of the recursion's 128 alignment."""
    kernel, ref = FAMILIES[family]
    X = _inputs(n, seed=2)
    Y = np.stack([np.sin(X.sum(-1)), np.cos(X[:, 0])], axis=-1)
    gp = jax.jit(gpr_tpu.fit)(kernel, jnp.asarray(X), jnp.asarray(Y), 0.1)
    A = ref(X, X) + 0.01 * np.eye(n)
    alpha = np.linalg.solve(A, Y)
    np.testing.assert_allclose(
        np.asarray(gp.alpha), alpha, rtol=0, atol=1e-7 * np.abs(alpha).max()
    )
    np.testing.assert_allclose(
        np.tril(np.asarray(gp.L)), np.linalg.cholesky(A), rtol=0, atol=1e-10
    )


@pytest.mark.parametrize("n", [1024, 1536, 2048])
def test_safe_cholesky_large_route_clean(n):
    X = _inputs(n, d=4, seed=n)
    A = FAMILIES["gaussian"][1](X, X) + 0.05 * np.eye(n)
    L, jitter = jax.jit(linalg.safe_cholesky)(jnp.asarray(A))
    assert float(jitter) == 0.0
    np.testing.assert_allclose(
        np.asarray(L), np.linalg.cholesky(A), rtol=0, atol=1e-10
    )


@pytest.mark.parametrize("n", [1024, 1536, 2048])
def test_safe_cholesky_large_route_duplicate_rows(n):
    """Every input repeated four times and no noise: K is singular, the
    factorization escalates the jitter and factors K + jitter I."""
    base = _inputs(n // 4, d=4, seed=n)
    X = np.concatenate([base] * 4)
    A = FAMILIES["gaussian"][1](X, X)
    L, jitter = jax.jit(linalg.safe_cholesky)(jnp.asarray(A))
    L, jitter = np.asarray(L), float(jitter)
    assert jitter > 0.0
    assert np.all(np.isfinite(L))
    np.testing.assert_allclose(
        L @ L.T, A + jitter * np.eye(n), rtol=0, atol=1e-9
    )


@pytest.mark.parametrize("q", [1, 8, 130])
@pytest.mark.parametrize("n", [1024, 1536])
def test_cho_solve_large_route(n, q):
    rng = np.random.default_rng(n + q)
    G = rng.standard_normal((n, 64))
    A = G @ G.T / 64 + 2.0 * np.eye(n)
    L = np.linalg.cholesky(A)
    B = rng.standard_normal((n, q))
    X = np.asarray(linalg.cho_solve(jnp.asarray(L), jnp.asarray(B)))
    np.testing.assert_allclose(X, sla.cho_solve((L, True), B), rtol=0, atol=1e-10)


@pytest.mark.parametrize("shape", [(4, 48, 2, 1), (3, 130, 3, 2)])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fleet_fit_matches_member_solves(family, shape):
    B, n, d, q = shape
    kernel, ref = FAMILIES[family]
    rng = np.random.default_rng(B * n)
    X = rng.uniform(-2.0, 2.0, (B, n, d))
    Y = rng.standard_normal((B, n, q))
    fleet = gpr_tpu.fit_batched(kernel, jnp.asarray(X), jnp.asarray(Y), 0.2)
    # the Matern Grams' sqrt(eps) error at coincident points (see
    # test_gram_matches_float64_direct), amplified by the solve
    rel = 1e-5 if family.startswith("matern") else 1e-9
    for b in range(B):
        alpha = np.linalg.solve(ref(X[b], X[b]) + 0.04 * np.eye(n), Y[b])
        np.testing.assert_allclose(
            np.asarray(fleet.alpha[b]), alpha, rtol=0,
            atol=rel * np.abs(alpha).max(),
        )


@pytest.mark.parametrize("B,n,q", [(2, 32, 1), (4, 40, 2), (3, 64, 3)])
def test_mll_batched_gradient_matches_member_fits(B, n, q):
    """d/dtheta of the summed fleet MLL equals the per-member
    ``mll_scalar`` gradients, summed; the values agree member by member."""
    rng = np.random.default_rng(B + n)
    X = jnp.asarray(rng.standard_normal((B, n, 2)))
    Y = jnp.asarray(rng.standard_normal((B, n, q)))
    sig = jnp.asarray(np.linspace(0.1, 0.3, B))

    def fleet(p):
        k = gpr_tpu.RationalQuadratic(p[0], p[1], p[2])
        return batched.mll_batched(k, X, Y, sig)

    member = jax.jit(jax.value_and_grad(
        lambda p, x, y, s: lk.mll_scalar(
            gpr_tpu.RationalQuadratic(p[0], p[1], p[2]), x, y, s
        )
    ))
    p0 = jnp.asarray([0.9, 1.2, 1.5])
    per = [member(p0, X[b], Y[b], sig[b]) for b in range(B)]
    np.testing.assert_allclose(
        np.asarray(fleet(p0)), [float(v) for v, _ in per], rtol=1e-10
    )
    g = jax.jit(jax.grad(lambda p: jnp.sum(fleet(p))))(p0)
    np.testing.assert_allclose(
        np.asarray(g), np.sum([np.asarray(gb) for _, gb in per], axis=0),
        rtol=1e-8,
    )
