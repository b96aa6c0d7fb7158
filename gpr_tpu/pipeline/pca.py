"""PCA dimensionality reduction.

Re-design of the reference ``PCA<T>`` (reference include/PCA.h:21-145).
Semantics preserved exactly:

  * data matrix ``X`` is (d, N): COLUMNS are samples (Eigen convention of
    the reference; d ~ 1e5-1e6 voxel features, N ~ 1e3 frames);
  * mean over columns; thin SVD of the centered matrix;
  * singular values scaled by 1/sqrt(N)  (PCA.h:44);
  * whitened projection basis  U diag(sigma)^-1  (PCA.h:46);
  * truncated inverse basis  (U diag(sigma))[:, :n_features] (PCA.h:47-48);
  * persistence to {prefix}Mean.bin / Sigma.bin / U.bin in the reference's
    MatrixIO format (PCA.h:126-134).

Difference from the reference: for d >> N (the production regime) the thin
SVD is computed via the N x N Gram matrix  X^T X = V S^2 V^T  — one large
GEMM plus an O(N^3) eigendecomposition of a small matrix —
instead of the reference's BDCSVD of the full d x N matrix (PCA.h:41).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax import tree_util

from ..utils import matrixio
from ..utils.config import matmul_precision


@dataclasses.dataclass(frozen=True)
class PCAModel:
    """Immutable PCA basis (pytree).

    mean   (d,)    per-feature mean (reference m_mean)
    sigma  (r,)    singular values / sqrt(N)  (reference m_sigma)
    U      (d, r)  left singular vectors      (reference m_U)
    """

    mean: jax.Array
    sigma: jax.Array
    U: jax.Array

    @property
    def num_modes(self) -> int:
        return self.sigma.shape[0]

    def basis(self, n_features: int = 0) -> jax.Array:
        """Whitened basis U diag(sigma)^-1, optionally truncated
        (reference PCA.h:82-90).

        Zero singular values (the centered matrix is always rank-deficient:
        rank <= N-1, and the Gram path clamps tiny negative eigenvalues to
        exactly 0) get a ZERO basis column instead of inf/NaN."""
        safe = jnp.where(self.sigma > 0, self.sigma, 1.0)
        B = jnp.where(self.sigma[None, :] > 0, self.U / safe[None, :], 0.0)
        if 0 < n_features < B.shape[1]:
            B = B[:, :n_features]
        return B

    def reduce(self, X, n_features: int = 0) -> jax.Array:
        """features = basis^T (X - mean): (d, N) -> (r or n_features, N)
        (reference DimensionalityReduction, PCA.h:92-101)."""
        X = jnp.asarray(X)
        Xc = X - self.mean[:, None]
        F = jax.lax.dot_general(
            self.basis(), Xc, (((0,), (0,)), ((), ())),
            preferred_element_type=X.dtype, precision=matmul_precision(),
        )
        if 0 < n_features < F.shape[0]:
            F = F[:n_features]
        return F

    def reconstruct(self, weights, n_features: Optional[int] = None) -> jax.Array:
        """X = (U diag(sigma))[:, :k] weights + mean: (k, N) -> (d, N)
        (reference GetReconstruction, PCA.h:110-115)."""
        W = jnp.asarray(weights)
        single = W.ndim == 1
        if single:
            W = W[:, None]
        k = W.shape[0] if n_features is None else n_features
        inv_basis = self.U[:, :k] * self.sigma[None, :k]
        out = jnp.matmul(inv_basis, W[:k], precision=matmul_precision())
        out = out + self.mean[:, None]
        return out[:, 0] if single else out

    def explained_variance(self) -> jax.Array:
        """Cumulative normalized spectrum (reference GetExplainedVariance,
        PCA.h:117-124: cumsum of sigma over its total)."""
        c = jnp.cumsum(self.sigma)
        return c / c[-1]

    def modes_for_compactness(self, threshold: float) -> int:
        """Smallest mode count reaching the given cumulative compactness —
        the model-analysis selection rule (reference
        scripts/model_analysis.py:17-30)."""
        ev = self.explained_variance()
        import numpy as np

        return int(np.searchsorted(np.asarray(ev), threshold) + 1)

    def save(self, prefix: str) -> None:
        """{prefix}Mean.bin / Sigma.bin / U.bin (reference PCA.h:126-134)."""
        import numpy as np

        matrixio.write_matrix(np.asarray(self.mean)[:, None], prefix + "Mean.bin")
        matrixio.write_matrix(np.asarray(self.sigma)[:, None], prefix + "Sigma.bin")
        matrixio.write_matrix(np.asarray(self.U), prefix + "U.bin")


tree_util.register_pytree_node(
    PCAModel,
    lambda p: ((p.mean, p.sigma, p.U), None),
    lambda _, c: PCAModel(*c),
)


def fit_pca(X, gram_threshold: int = 4096) -> PCAModel:
    """Fit the PCA basis on data X (d, N), columns = samples.

    Uses the Gram trick (eigh of X^T X, size N x N) when d > N — the
    accelerator path: one (N, d) x (d, N) GEMM — and a direct thin
    SVD otherwise.  Matches the reference's 1/sqrt(N) scaling (PCA.h:44).
    """
    X = jnp.asarray(X)
    d, N = X.shape
    mean = jnp.mean(X, axis=1)
    Xc = X - mean[:, None]

    if d > N and d > gram_threshold:
        G = jax.lax.dot_general(
            Xc, Xc, (((0,), (0,)), ((), ())), preferred_element_type=X.dtype,
            precision=matmul_precision(),
        )  # (N, N) = Xc^T Xc
        evals, V = jnp.linalg.eigh(G)  # ascending
        evals = jnp.maximum(evals[::-1], 0.0)
        V = V[:, ::-1]
        s = jnp.sqrt(evals)  # singular values of Xc
        # guard the inverse scale for (numerically) zero singular values
        safe = jnp.where(s > 0, s, 1.0)
        U = jnp.matmul(Xc, V, precision=matmul_precision()) / safe[None, :]
    else:
        U, s, _ = jnp.linalg.svd(Xc, full_matrices=False)

    sigma = s / jnp.sqrt(jnp.asarray(N, X.dtype))
    return PCAModel(mean=mean, sigma=sigma, U=U)


def load_pca(prefix: str, dtype=None) -> PCAModel:
    """Load a basis written by :meth:`PCAModel.save` — or by the reference
    (PCA.h:51-65)."""
    mean = matrixio.read_matrix(prefix + "Mean.bin", dtype).ravel()
    sigma = matrixio.read_matrix(prefix + "Sigma.bin", dtype).ravel()
    U = matrixio.read_matrix(prefix + "U.bin", dtype)
    return PCAModel(
        mean=jnp.asarray(mean), sigma=jnp.asarray(sigma), U=jnp.asarray(U)
    )
