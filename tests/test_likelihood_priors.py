"""Likelihood and prior density tests.

Semantics ported from reference tests/GaussianLikelihoodTest.cpp (brute-force
vs gradient MLE), tests/PriorTest.cpp (parameter solvers), and the analytic
gradient identity 0.5 tr((alpha alpha^T - C) dK/dtheta)
(include/Likelihood.h:204-229)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gpr_tpu as gt
from gpr_tpu.gp import likelihood as lk
from gpr_tpu.kernels import kernels as kermod
from gpr_tpu.inference import priors as pr
from gpr_tpu.inference.optimize import fit_mle, fit_map, GaussNewtonInference, reference_objective


def _sinus_data(n=10, noise=0.0, rng=None):
    xs = np.arange(n) * 2 * math.pi / n
    ys = np.sin(xs)
    if noise and rng is not None:
        ys = ys + noise * rng.standard_normal(n)
    return xs[:, None], ys[:, None]


# ---------------------------------------------------------------------------
# likelihood values & gradients
# ---------------------------------------------------------------------------

def test_mll_value_matches_direct_formula(rng):
    """value_i = -0.5 y_i' C y_i - 0.5 log|K+s^2 I| - n/2 log 2pi
    (reference Likelihood.h:166-202) against explicit numpy arithmetic."""
    X = rng.standard_normal((12, 2))
    Y = rng.standard_normal((12, 3))
    k = gt.Gaussian(1.3, 0.9)
    sigma = 0.5
    K = np.asarray(gt.gram(k, jnp.asarray(X))) + sigma**2 * np.eye(12)
    C = np.linalg.inv(K)
    df = -0.5 * np.einsum("ni,nm,mi->i", Y, C, Y)
    sign, logdet = np.linalg.slogdet(K)
    ref = df - 0.5 * logdet - 12 / 2 * math.log(2 * math.pi)
    got = np.asarray(lk.gaussian_log_likelihood(k, X, Y, sigma))
    np.testing.assert_allclose(got, ref, rtol=1e-9)


def test_gaussian_likelihood_is_exp_of_log(rng):
    X = rng.standard_normal((8, 1))
    Y = rng.standard_normal((8, 1))
    k = gt.Gaussian(1.0, 1.0)
    log_v = np.asarray(lk.gaussian_log_likelihood(k, X, Y, 0.3))
    v = np.asarray(lk.gaussian_likelihood(k, X, Y, 0.3))
    np.testing.assert_allclose(v, np.exp(log_v), rtol=1e-9)


def test_mll_grad_matches_reference_trace_formula(rng):
    """Autodiff gradient equals the reference's analytic
    0.5 tr((alpha alpha' - C) D_p) (Likelihood.h:224-228), computed here
    with explicit matrices."""
    X = rng.standard_normal((10, 2))
    Y = rng.standard_normal((10, 2))
    k = gt.Sum(gt.Gaussian(1.4, 1.1), gt.Periodic(1.2, 0.7, 0.9))
    sigma = 0.4
    _, grad = lk.mll_value_and_grad(k, X, Y, sigma)
    grad = np.asarray(grad)

    K = np.asarray(gt.gram(k, jnp.asarray(X))) + sigma**2 * np.eye(10)
    C = np.linalg.inv(K)
    alpha = C @ Y
    D = np.asarray(kermod.analytic_gram_derivative(k, jnp.asarray(X)))
    ref = np.array(
        [0.5 * np.trace((alpha @ alpha.T - C) @ D[p]) for p in range(D.shape[0])]
    )
    np.testing.assert_allclose(grad, ref, rtol=1e-7, atol=1e-9)


def test_mll_jacobian_rows(rng):
    """Per-output-dim jacobian (reference GetValueAndJacobian,
    Likelihood.h:287-344): row i = 0.5 tr((a_i a_i' - C) D_p)."""
    X = rng.standard_normal((9, 1))
    Y = rng.standard_normal((9, 2))
    k = gt.Gaussian(1.2, 0.8)
    sigma = 0.3
    _, J = lk.mll_jacobian(k, X, Y, sigma)
    J = np.asarray(J)
    K = np.asarray(gt.gram(k, jnp.asarray(X))) + sigma**2 * np.eye(9)
    C = np.linalg.inv(K)
    D = np.asarray(kermod.analytic_gram_derivative(k, jnp.asarray(X)))
    for i in range(2):
        a = C @ Y[:, i : i + 1]
        for p in range(D.shape[0]):
            ref = 0.5 * np.trace((a @ a.T - C) @ D[p])
            assert abs(J[i, p] - ref) < 1e-8, (i, p, J[i, p], ref)


# ---------------------------------------------------------------------------
# MLE (reference GaussianLikelihoodTest / MaximumLikelihoodTest2)
# ---------------------------------------------------------------------------

def test_brute_force_vs_gradient_mle(rng):
    """Brute-force grid search and gradient MLE agree on the best
    length-scale region, and the MLE model predicts well (reference
    tests/GaussianLikelihoodTest.cpp:57-153: grid at :102-125, mean
    prediction error gate < 2 at :139)."""
    X, Y = _sinus_data(12, noise=0.05, rng=rng)
    sigma = 0.1

    # brute force over kernel sigma
    grid = np.linspace(0.5, 4.0, 36)
    vals = [
        float(lk.mll_scalar(gt.Gaussian(s, 1.0), X, Y, sigma)) for s in grid
    ]
    best_grid = grid[int(np.argmax(vals))]

    kstar, res = fit_mle(gt.Gaussian(0.7, 1.0), X, Y, sigma, iterations=300,
                         learning_rate=0.03)
    assert abs(float(kstar.sigma) - best_grid) < 0.5, (float(kstar.sigma), best_grid)

    gp = gt.fit(kstar, X, Y, sigma=sigma)
    xt = np.linspace(0, 2 * math.pi, 50, endpoint=False)[:, None]
    err = np.mean(np.abs(np.asarray(gp.predict(jnp.asarray(xt)))[:, 0] - np.sin(xt[:, 0])))
    assert err < 2.0, err  # reference gate
    assert err < 0.2, err  # much tighter in practice


def test_fit_mle_unroll_chunk_matches_scan(rng):
    """The python-unrolled chunked optax loop (same contract as the
    chunked samplers) reproduces the scan-based loop."""
    X, Y = _sinus_data(12, noise=0.05, rng=rng)
    sigma = 0.1
    k_scan, r_scan = fit_mle(gt.Gaussian(0.7, 1.0), X, Y, sigma,
                             iterations=25, learning_rate=0.03)
    k_chunk, r_chunk = fit_mle(gt.Gaussian(0.7, 1.0), X, Y, sigma,
                               iterations=25, learning_rate=0.03,
                               unroll_chunk=7)  # exercises the remainder
    np.testing.assert_allclose(np.asarray(r_chunk.params),
                               np.asarray(r_scan.params), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(r_chunk.trace),
                               np.asarray(r_scan.trace), rtol=1e-9)


def test_gauss_newton_inference_runs(rng):
    """The reference-compatible Gauss-Newton scheme
    (GaussianProcessInference.h:84-156) improves the likelihood."""
    X, Y = _sinus_data(10)
    sigma = 0.1
    k0 = gt.Gaussian(1.0, 1.0)
    vg, vj = reference_objective(k0, jnp.asarray(X), jnp.asarray(Y), sigma)
    opt = GaussNewtonInference(vg, [1.0, 1.0], step_width=0.1, iterations=30,
                               objective_value_and_jacobian=vj)
    v0 = float(vg(opt.params)[0][0])
    params = opt.optimize(verbose=False)
    v1 = float(vg(params)[0][0])
    assert v1 > v0, (v0, v1)


def test_gauss_newton_freeze_mask(rng):
    """Per-parameter freeze mask (reference SetParametersToOptimize,
    GaussianProcessInference.h:78-82, exercised by
    MaximumAPosterioriTest.cpp:211,349)."""
    X, Y = _sinus_data(10)
    k0 = gt.Gaussian(1.0, 1.0)
    vg, vj = reference_objective(k0, jnp.asarray(X), jnp.asarray(Y), 0.1)
    opt = GaussNewtonInference(vg, [1.0, 1.0], step_width=0.1, iterations=10,
                               objective_value_and_jacobian=vj)
    opt.set_parameters_to_optimize([True, False])
    params = np.asarray(opt.optimize2(verbose=False))
    assert params[1] == 1.0  # frozen
    assert params[0] != 1.0  # optimized


# ---------------------------------------------------------------------------
# MAP (reference MaximumAPosterioriTest.cpp)
# ---------------------------------------------------------------------------

def test_map_recovers_parameters(rng):
    """MAP with informative priors recovers the generating length-scale
    within the reference's gate (mean error < 0.5,
    MaximumAPosterioriTest.cpp:199)."""
    true_sigma = 2.0
    X, Y = _sinus_data(14, noise=0.05, rng=rng)
    priors = [
        pr.InverseGaussianDensity.from_mode_and_variance(true_sigma, 1.0),
        None,
    ]
    kstar, _ = fit_map(
        gt.Gaussian(1.0, 1.0), X, Y, 0.1, priors, iterations=300, learning_rate=0.03
    )
    gp = gt.fit(kstar, X, Y, sigma=0.1)
    xt = np.linspace(0, 2 * math.pi, 50, endpoint=False)[:, None]
    err = np.mean(np.abs(np.asarray(gp.predict(jnp.asarray(xt)))[:, 0] - np.sin(xt[:, 0])))
    assert err < 0.5, err


# ---------------------------------------------------------------------------
# priors (reference PriorTest.cpp + analytic derivative golden checks)
# ---------------------------------------------------------------------------

DENSITIES = [
    pr.GaussianDensity(1.0, 2.0),
    pr.LogGaussianDensity(0.5, 0.7),
    pr.InverseGaussianDensity(2.0, 1.5),
    pr.GammaDensity(3.0, 2.0),
]


@pytest.mark.parametrize("d", DENSITIES, ids=[type(d).__name__ for d in DENSITIES])
def test_pdf_integrates_to_one(d):
    xs = np.linspace(1e-6, 60.0, 400000)
    p = np.asarray(d.pdf(jnp.asarray(xs)))
    if isinstance(d, pr.GaussianDensity):
        xs = np.linspace(-20, 20, 400000)
        p = np.asarray(d.pdf(jnp.asarray(xs)))
    integral = np.trapezoid(p, xs)
    assert abs(integral - 1.0) < 1e-3, integral


@pytest.mark.parametrize("d", DENSITIES, ids=[type(d).__name__ for d in DENSITIES])
def test_log_derivative_matches_autodiff(d):
    for x in (0.5, 1.0, 2.5):
        auto = float(jax.grad(lambda t: d.log_pdf(t))(jnp.asarray(x)))
        analytic = float(d.log_derivative(jnp.asarray(x)))
        assert abs(auto - analytic) < 1e-8, (type(d).__name__, x, auto, analytic)


@pytest.mark.parametrize("d", DENSITIES, ids=[type(d).__name__ for d in DENSITIES])
def test_cdf_icdf_roundtrip(d):
    for u in (0.1, 0.5, 0.9):
        lo = -1e8 if isinstance(d, pr.GaussianDensity) else 1e-10
        x = float(d.icdf(u, a=lo, b=1e8))
        assert abs(float(d.cdf(x)) - u) < 1e-7, (type(d).__name__, u, x)


@pytest.mark.parametrize("d", DENSITIES, ids=[type(d).__name__ for d in DENSITIES])
def test_sampling_moments(d):
    key = jax.random.PRNGKey(3)
    s = np.asarray(d.sample(key, (200000,)))
    assert abs(np.mean(s) - float(d.mean())) < 0.05 * max(1.0, abs(float(d.mean())))


def test_loggaussian_solver():
    """Reference PriorTest.cpp: LogGaussian mode/variance -> (mu, sigma)."""
    d = pr.LogGaussianDensity.from_mode_and_variance(2.0, 1.5)
    assert abs(float(d.mode()) - 2.0) < 1e-9
    assert abs(float(d.variance()) - 1.5) < 1e-9


def test_inverse_gaussian_solvers_agree():
    """Reference PriorTest.cpp: Bisection vs Halley solver agreement."""
    d1 = pr.InverseGaussianDensity.from_mode_and_variance(1.2, 0.8, "halley")
    d2 = pr.InverseGaussianDensity.from_mode_and_variance(1.2, 0.8, "bisection")
    assert abs(float(d1.mu) - float(d2.mu)) < 1e-8
    assert abs(float(d1.mode()) - 1.2) < 1e-10
    assert abs(float(d1.variance()) - 0.8) < 1e-10


def test_gamma_solver():
    """Reference Prior.h:739-744 closed-form alpha/beta from mode+variance.

    NOTE (documented reference quirk): GetBeta = sqrt(alpha/variance) solves
    variance = alpha/beta^2, but then mode = (alpha-1)/beta does NOT equal
    the requested mode — the reference's two formulas are mutually
    inconsistent.  We reproduce the formulas exactly and assert the variance
    relation they do satisfy."""
    alpha = pr.GammaDensity.get_alpha(2.0, 1.0)
    beta = pr.GammaDensity.get_beta(2.0, 1.0)
    assert abs(alpha / beta**2 - 1.0) < 1e-10  # variance relation holds


def test_invalid_parameters_rejected():
    with pytest.raises(ValueError):
        pr.GaussianDensity(0.0, -1.0)
    with pytest.raises(ValueError):
        pr.GammaDensity(-1.0, 1.0)
    with pytest.raises(ValueError):
        pr.InverseGaussianDensity(0.0, 1.0)
    with pytest.raises(ValueError):
        pr.LogGaussianDensity(0.0, 0.0)


def test_get_samples_grid():
    """Reference PriorUtils.h:33-58: equidistant inverse-transform samples
    clipped to mode +/- std."""
    d = pr.GammaDensity(4.0, 2.0)
    s = pr.get_samples(d, 7)
    assert len(s) == 7
    assert np.all(np.diff(s) > 0)  # monotone grid
    mode, std = float(d.mode()), math.sqrt(float(d.variance()))
    assert s[0] >= mode - std - 1e-6 and s[-1] <= mode + std + 1e-6


# ---------------------------------------------------------------------------
# end-to-end MLL gradients across every kernel family
# ---------------------------------------------------------------------------

MLL_GRAD_KERNELS = [
    gt.Gaussian(2.5, 1.3),
    gt.GaussianExp(0.7, 0.4),
    gt.RationalQuadratic(1.2, 2.0, 3.0),
    gt.Periodic(1.5, 0.8, 1.1),
    kermod.Matern12(1.4, 0.9),
    kermod.Matern32(1.5, 0.8),
    kermod.Matern52(2.0, 1.0),
    kermod.GaussianARD(jnp.asarray([1.7, 0.9, 2.2]), 1.1),
    kermod.Linear(0.8, 0.3),
    kermod.Constant(1.5),
    gt.Sum(gt.Gaussian(2.0, 1.0), kermod.Matern32(1.5, 0.8)),
    gt.Product(kermod.Matern52(1.3, 0.9), gt.Periodic(1.5, 0.8, 1.1)),
]


@pytest.mark.parametrize(
    "kernel", MLL_GRAD_KERNELS, ids=[k.to_string() for k in MLL_GRAD_KERNELS]
)
def test_mll_grad_finite_difference_all_families(kernel, rng):
    """The gradient the hyperparameter optimizers consume — jax.grad of the
    marginal likelihood wrt the reference-ordered parameter vector — must
    match central finite differences for EVERY kernel family, including the
    extension kernels and composite trees (the end-to-end analogue of
    tests/KernelDerivativeTest.cpp, which only checks k(x,y) itself)."""
    X = jnp.asarray(rng.standard_normal((12, 3)))
    Y = jnp.asarray(rng.standard_normal((12, 2)))
    sigma = 0.05
    vec0 = kermod.params_vector(kernel)

    def f(vec):
        return lk.mll_scalar(kernel.with_params(list(vec)), X, Y, sigma)

    auto = np.asarray(jax.grad(f)(vec0))
    h = 1e-5
    fd = np.empty_like(auto)
    for i in range(vec0.shape[0]):
        e = jnp.zeros_like(vec0).at[i].set(h)
        fd[i] = (float(f(vec0 + e)) - float(f(vec0 - e))) / (2 * h)
    np.testing.assert_allclose(auto, fd, rtol=2e-4, atol=1e-6)


def test_optimize2_improves_objective(rng):
    """Update direction parity: the reference's sign loop makes every
    likelihood entry NON-positive before the Gauss-Newton solve
    (GaussianProcessInference.h:178-181); with typical negative MLL values
    optimize2 must therefore IMPROVE the objective."""
    X, Y = _sinus_data(12)
    start = [3.0, 1.0]
    vg, vj = reference_objective(gt.Gaussian(*start), jnp.asarray(X),
                                 jnp.asarray(Y), 0.1)
    v0 = float(vg(jnp.asarray(start))[0][0])
    opt = GaussNewtonInference(vg, list(start), step_width=0.05,
                               iterations=15,
                               objective_value_and_jacobian=vj)
    p = np.asarray(opt.optimize2(verbose=False))
    v1 = float(vg(jnp.asarray(p))[0][0])
    assert v1 > v0 + 1.0, (v0, v1)
