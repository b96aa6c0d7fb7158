"""Sparse (inducing-point) GP regression — projected-process / SoR style.

Re-design of the reference ``gpr::SparseGaussianProcess``
(reference include/SparseGaussianProcess.h:30-416) and
``SparseGaussianLogLikelihood`` (include/SparseLikelihood.h:112-551).

Model semantics follow the reference exactly:

  training (SparseGaussianProcess.h:274-313):
    Kmm   = k(Z, Z) + jitter I           (inducing Gram)
    Knm   = k(X, Z)                      (cross-covariance)
    Sigma = inv(Kmm + s^-2 Kmn Knm)
    alpha = inv(Kmm) (s^-2 Kmm Sigma Kmn Y)     -> mean weights
    R     = inv(Kmm) Kmm Sigma Kmm inv(Kmm)     -> variance weights

  prediction (SparseGaussianProcess.h:86-106):
    mean(x)    = Kx^T alpha
    cov(x, y)  = k(x,y) - Kx^T inv(Kmm) Ky + Kx^T R Ky

  marginal likelihood (SparseLikelihood.h:129-217) with
  C = s^2 I + Knm inv(Kmm) Kmn handled by the Woodbury identity
  (EfficientInversion, SparseLikelihood.h:132-138) and the matrix
  determinant lemma (EfficientDeterminant, SparseLikelihood.h:142-150) —
  O(n m^2) instead of O(n^3), all in log space via Cholesky factors.

All inverses are replaced by Cholesky solves; gradients w.r.t. kernel
hyperparameters AND inducing locations come from ``jax.grad`` (the
reference hand-assembles grad(C) per parameter, SparseLikelihood.h:253-259).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import jax
import jax.numpy as jnp
from jax import tree_util

from ..kernels import kernels as kermod
from ..ops import linalg
from ..utils.config import matmul_precision


@dataclasses.dataclass(frozen=True)
class SparseGP:
    """Trained sparse GP (immutable pytree)."""

    kernel: Any
    Z: jax.Array  # (m, d) inducing inputs (reference m_InducingSampleVectors)
    X: jax.Array  # (n, d) dense inputs
    Y: jax.Array  # (n, q) dense labels
    sigma: Any
    jitter: Any
    alpha: jax.Array  # (m, q) mean regression weights
    R: jax.Array  # (m, m) variance regression matrix
    Lmm: jax.Array  # chol(Kmm + jitter I)

    def predict(self, Xs) -> jax.Array:
        Xs2 = jnp.atleast_2d(jnp.asarray(Xs))
        single = jnp.asarray(Xs).ndim <= 1
        Ks = kermod.gram(self.kernel, Xs2, self.Z)  # (t, m)
        mean = jnp.matmul(Ks, self.alpha, precision=matmul_precision())
        return mean[0] if single else mean

    def posterior_cov(self, x, y) -> jax.Array:
        """cov(x,y) = k(x,y) - Kx^T inv(Kmm) Ky + Kx^T R Ky
        (reference SparseGaussianProcess.h:94-106)."""
        Kx = kermod.kvec(self.kernel, self.Z, x)
        Ky = kermod.kvec(self.kernel, self.Z, y)
        kxy = self.kernel(jnp.atleast_1d(x), jnp.atleast_1d(y))
        prec = matmul_precision()
        return (
            kxy
            - jnp.matmul(Kx, linalg.cho_solve(self.Lmm, Ky), precision=prec)
            + jnp.matmul(Kx, jnp.matmul(self.R, Ky, precision=prec),
                         precision=prec)
        )

    def credible_interval(self, x) -> jax.Array:
        c = self.posterior_cov(x, x)
        return 2.0 * jnp.sqrt(jnp.maximum(0.0, c))

    @property
    def num_inducing(self) -> int:
        return self.Z.shape[0]


def _flatten(s: SparseGP):
    return (
        s.kernel,
        s.Z,
        s.X,
        s.Y,
        s.sigma,
        s.jitter,
        s.alpha,
        s.R,
        s.Lmm,
    ), None


tree_util.register_pytree_node(
    SparseGP, _flatten, lambda _, c: SparseGP(*c)
)


def fit_sparse(kernel, Z, X, Y, sigma: float, jitter: float = 0.0) -> SparseGP:
    """Train the sparse GP (reference PreComputeRegression,
    SparseGaussianProcess.h:274-313), Cholesky-solve based."""
    Z = jnp.atleast_2d(jnp.asarray(Z))
    X = jnp.atleast_2d(jnp.asarray(X))
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    if Z.shape[0] > X.shape[0]:
        raise ValueError(
            "SparseGaussianProcess::ComputeKernelVectorMatrix: number of dense "
            "samples must be higher than the number of sparse samples"
        )
    m = Z.shape[0]
    dtype = X.dtype

    Kmm = kermod.gram(kernel, Z)
    Kmm_j = linalg.add_diagonal(Kmm, jnp.asarray(jitter, dtype))
    Lmm, _ = linalg.safe_cholesky(Kmm_j)

    Knm = kermod.gram(kernel, X, Z)  # (n, m)
    inv_s2 = 1.0 / (jnp.asarray(sigma, dtype) ** 2)

    # Sigma = inv(Kmm + s^-2 Kmn Knm)
    S = Kmm_j + inv_s2 * jnp.matmul(Knm.T, Knm, precision=matmul_precision())
    Ls, _ = linalg.safe_cholesky(S)

    # alpha = inv(Kmm) (s^-2 Kmm Sigma Kmn Y)  ==  s^-2 Sigma Kmn Y
    # (the reference's Kmm inv(Kmm) pair cancels analytically;
    #  SparseGaussianProcess.h:303 keeps them explicit)
    alpha = inv_s2 * linalg.cho_solve(
        Ls, jnp.matmul(Knm.T, Y, precision=matmul_precision())
    )

    # R = inv(Kmm) Kmm Sigma Kmm inv(Kmm) == Sigma
    # (again the reference keeps the cancelling pair explicit, :306)
    eye = jnp.eye(m, dtype=dtype)
    R = linalg.cho_solve(Ls, eye)

    return SparseGP(
        kernel=kernel,
        Z=Z,
        X=X,
        Y=Y,
        sigma=jnp.asarray(sigma, dtype),
        jitter=jnp.asarray(jitter, dtype),
        alpha=alpha,
        R=R,
        Lmm=Lmm,
    )


# ---------------------------------------------------------------------------
# Woodbury marginal likelihood
# ---------------------------------------------------------------------------

def _woodbury_pieces(kernel, Z, X, sigma, jitter):
    """Factorizations shared by the likelihood value and the solves.

    C = s^2 I + Knm inv(Kmm) Kmn.  With inner = Kmm + s^-2 Kmn Knm
    (the UNSCALED Woodbury inner matrix the code factors):
      inv(C) b = s^-2 (b - Knm inner^-1 (Kmn b) s^-2)
      log|C|   = n log s^2 + log|inner| - log|Kmm|
    both O(n m^2) (the reference's EfficientInversion / EfficientDeterminant,
    SparseLikelihood.h:129-150, done in log space)."""
    Z = jnp.atleast_2d(jnp.asarray(Z))
    X = jnp.atleast_2d(jnp.asarray(X))
    n = X.shape[0]
    m = Z.shape[0]
    dtype = X.dtype
    s2 = jnp.asarray(sigma, dtype) ** 2

    Kmm = linalg.add_diagonal(kermod.gram(kernel, Z), jnp.asarray(jitter, dtype))
    Lmm, _ = linalg.safe_cholesky(Kmm)
    Knm = kermod.gram(kernel, X, Z)

    inner = Kmm + jnp.matmul(Knm.T, Knm, precision=matmul_precision()) / s2
    Linner, _ = linalg.safe_cholesky(inner)

    logdet_C = (
        (n) * jnp.log(s2)
        + linalg.logdet_from_chol(Linner)
        - linalg.logdet_from_chol(Lmm)
    )
    return Lmm, Knm, Linner, s2, logdet_C, n, m


def woodbury_solve(Knm, Linner, s2, B):
    """inv(C) @ B with C = s^2 I + Knm inv(Kmm) Kmn.

    (A + U B U^T)^-1 = A^-1 - A^-1 U (B^-1 + U^T A^-1 U)^-1 U^T A^-1 with
    A = s^2 I, B = inv(Kmm):  inv(C) b = s^-2 (b - Knm inner^-1 (Kmn b) s^-2)
    where inner = Kmm + s^-2 Kmn Knm (factored as Linner)."""
    prec = matmul_precision()
    t = jnp.matmul(Knm.T, B, precision=prec) / s2  # (m, q)
    u = linalg.cho_solve(Linner, t)
    return (B - jnp.matmul(Knm, u, precision=prec)) / s2


def sparse_log_likelihood(kernel, Z, X, Y, sigma, jitter: float = 0.0) -> jax.Array:
    """Per-output-dim log marginal likelihood of the sparse model
    (reference SparseGaussianLogLikelihood::operator(),
    SparseLikelihood.h:152-217): value_i = -0.5 y_i^T inv(C) y_i
    - 0.5 log|C| - n/2 log 2pi."""
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    Lmm, Knm, Linner, s2, logdet_C, n, m = _woodbury_pieces(
        kernel, Z, X, sigma, jitter
    )
    CinvY = woodbury_solve(Knm, Linner, s2, Y)
    df = -0.5 * jnp.sum(Y * CinvY, axis=0)
    cp = -0.5 * logdet_C
    ct = -n / 2.0 * math.log(2 * math.pi)
    return df + cp + ct


def sparse_mll_scalar(kernel, Z, X, Y, sigma, jitter: float = 0.0) -> jax.Array:
    """Scalar objective (sum over output dims + complexity once), the sparse
    analogue of the reference's GetValueAndParameterDerivatives target
    (SparseLikelihood.h:287-409)."""
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    Lmm, Knm, Linner, s2, logdet_C, n, m = _woodbury_pieces(
        kernel, Z, X, sigma, jitter
    )
    CinvY = woodbury_solve(Knm, Linner, s2, Y)
    df = -0.5 * jnp.sum(Y * CinvY)
    return df - 0.5 * logdet_C - n / 2.0 * math.log(2 * math.pi)


def sparse_mll_value_and_grad(kernel, Z, X, Y, sigma, jitter: float = 0.0):
    """(value_vector, grad wrt reference-ordered kernel params) — sparse
    analogue of reference SparseLikelihood.h:287-409 via autodiff."""
    vec0 = kermod.params_vector(kernel)

    def f(vec):
        return sparse_mll_scalar(kernel.with_params(list(vec)), Z, X, Y, sigma, jitter)

    grad = jax.grad(f)(vec0)
    value = sparse_log_likelihood(kernel, Z, X, Y, sigma, jitter)
    return value, grad


def sparse_mll_and_grad_inducing(kernel, Z, X, Y, sigma, jitter: float = 0.0):
    """Gradient w.r.t. the inducing locations Z — enables variational-style
    optimization of inducing points (beyond the reference, which keeps Z
    fixed; cf. BASELINE.json 'VI over inducing locations')."""
    val, g = jax.value_and_grad(
        lambda z: sparse_mll_scalar(kernel, z, X, Y, sigma, jitter)
    )(jnp.atleast_2d(jnp.asarray(Z)))
    return val, g


def optimize_inducing(
    kernel,
    Z0,
    X,
    Y,
    sigma,
    jitter: float = 0.0,
    iterations: int = 100,
    learning_rate: float = 0.01,
):
    """Gradient-ascent on the sparse MLL over inducing locations (VI-style
    sparse GP; the north-star extension named in BASELINE.json)."""
    import optax

    Z0 = jnp.atleast_2d(jnp.asarray(Z0))
    opt = optax.adam(learning_rate)

    @jax.jit
    def step(carry, _):
        z, state = carry
        val, g = jax.value_and_grad(
            lambda zz: -sparse_mll_scalar(kernel, zz, X, Y, sigma, jitter)
        )(z)
        updates, state = opt.update(g, state, z)
        z = optax.apply_updates(z, updates)
        return (z, state), -val

    (z, _), trace = jax.lax.scan(step, (Z0, opt.init(Z0)), None, length=iterations)
    return z, trace


# ---------------------------------------------------------------------------
# Titsias variational bound (SVGP)
# ---------------------------------------------------------------------------

def titsias_elbo(kernel, Z, X, Y, sigma, jitter: float = 0.0) -> jax.Array:
    """Collapsed variational lower bound (Titsias 2009):

        ELBO = log N(y | 0, s^2 I + Q_nn) - 1/(2 s^2) tr(K_nn - Q_nn)

    i.e. the projected-process marginal likelihood this module already
    computes (``sparse_mll_scalar``) minus the trace penalty for the
    variance the inducing points fail to explain.  Beyond the reference
    (which has only the uncorrected sparse likelihood,
    SparseLikelihood.h:152-217) — this is the principled objective for
    optimizing inducing locations, named in BASELINE.json ("VI over
    inducing locations")."""
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    X2 = jnp.atleast_2d(jnp.asarray(X))
    Z2 = jnp.atleast_2d(jnp.asarray(Z))
    dtype = X2.dtype
    s2 = jnp.asarray(sigma, dtype) ** 2

    base = sparse_mll_scalar(kernel, Z2, X2, Y, sigma, jitter)

    Kmm = linalg.add_diagonal(kermod.gram(kernel, Z2), jnp.asarray(jitter, dtype))
    Lmm, _ = linalg.safe_cholesky(Kmm)
    Knm = kermod.gram(kernel, X2, Z2)
    # diag(Q_nn) = rowsum(V * V), V = Knm Lmm^-T
    V = jax.scipy.linalg.solve_triangular(Lmm, Knm.T, lower=True)  # (m, n)
    q_diag = jnp.sum(V * V, axis=0)
    k_diag = jax.vmap(lambda v: kernel(v, v))(X2)
    trace_term = jnp.sum(k_diag - q_diag) / (2.0 * s2)
    return base - trace_term


def fit_svgp(
    kernel,
    Z0,
    X,
    Y,
    sigma,
    jitter: float = 0.0,
    iterations: int = 200,
    learning_rate: float = 0.01,
    optimize_hyperparameters: bool = True,
):
    """Joint gradient ascent of the Titsias ELBO over inducing locations
    and (optionally) log-hyperparameters; returns the trained SparseGP and
    the ELBO trace."""
    import optax

    Z0 = jnp.atleast_2d(jnp.asarray(Z0))
    theta0 = jnp.log(kermod.params_vector(kernel))
    params0 = {"Z": Z0, "log_theta": theta0}
    opt = optax.adam(learning_rate)

    def negelbo(params):
        k = kernel.with_params(list(jnp.exp(params["log_theta"])))
        if not optimize_hyperparameters:
            k = kernel
        return -titsias_elbo(k, params["Z"], X, Y, sigma, jitter)

    @jax.jit
    def step(carry, _):
        params, state = carry
        val, g = jax.value_and_grad(negelbo)(params)
        if not optimize_hyperparameters:
            g = dict(g, log_theta=jnp.zeros_like(g["log_theta"]))
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        return (params, state), -val

    (params, _), trace = jax.lax.scan(
        step, (params0, opt.init(params0)), None, length=iterations
    )
    k_final = (
        kernel.with_params(list(jnp.exp(params["log_theta"])))
        if optimize_hyperparameters
        else kernel
    )
    return fit_sparse(k_final, params["Z"], X, Y, sigma, jitter), trace


# ---------------------------------------------------------------------------
# persistence (beyond the reference: its SparseGaussianProcess inherits the
# dense Save/Load, which does not round-trip inducing state)
# ---------------------------------------------------------------------------

def save_sparse(sgp: SparseGP, path: str) -> None:
    """One-file npz artifact: arrays + the kernel serialized in the
    kernel-string DSL (same serializer as the dense 5-file set)."""
    import numpy as np

    from ..kernels.dsl import kernel_to_string

    np.savez(
        path,
        kernel_string=np.array(kernel_to_string(sgp.kernel)),
        Z=np.asarray(sgp.Z),
        X=np.asarray(sgp.X),
        Y=np.asarray(sgp.Y),
        sigma=np.asarray(sgp.sigma),
        jitter=np.asarray(sgp.jitter),
        alpha=np.asarray(sgp.alpha),
        R=np.asarray(sgp.R),
        Lmm=np.asarray(sgp.Lmm),
    )


def load_sparse(path: str) -> SparseGP:
    import numpy as np

    from ..kernels.dsl import parse_kernel

    z = np.load(path)
    return SparseGP(
        kernel=parse_kernel(str(z["kernel_string"])),
        Z=jnp.asarray(z["Z"]),
        X=jnp.asarray(z["X"]),
        Y=jnp.asarray(z["Y"]),
        sigma=jnp.asarray(z["sigma"]),
        jitter=jnp.asarray(z["jitter"]),
        alpha=jnp.asarray(z["alpha"]),
        R=jnp.asarray(z["R"]),
        Lmm=jnp.asarray(z["Lmm"]),
    )
