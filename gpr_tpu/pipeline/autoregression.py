"""Linear autoregressive AR(p) model over batched feature time series.

Re-design of the reference ``AutoRegression<T>`` (reference
include/AutoRegression.h:20-205).  Semantics preserved exactly:

  * the time series is a matrix X (T, F): rows = time steps, columns =
    independent feature channels, organized as contiguous *batches*
    (ultrasound sweeps) described by (size, repetition) pairs;
  * per batch of length B the zero-padded delay embedding D (B-1, p) has
    D[t, k] = X[t-k] for t >= k and 0 otherwise, with targets Y[t] = X[t+1]
    (reference ComputeSubmatrix, AutoRegression.h:189-199);
  * the model theta (p, F) is the least-squares solution per feature
    (reference AutoRegression.h:106, thin-SVD solve);
  * n-step-ahead rollout shifts the prediction into the design matrix each
    step (reference AutoRegression.h:166-173);
  * ``one_prediction_per_batch`` keeps only the last valid row per batch —
    including the reference's quirk of using the FIRST batch size for the
    stride even with heterogeneous batches (AutoRegression.h:176-183);
  * persistence as a single MatrixIO file (reference AutoRegression.h:36-44).

Difference from the reference: the reference loops over features and solves one
BDCSVD per feature (AutoRegression.h:79-107); here the embedding is built
once for ALL features as a (T-1, p, F) tensor with static shapes and the
solve/rollout are batched einsums — no per-feature loop, no dynamic shapes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..utils.config import matmul_precision

from ..utils import matrixio

BatchSpec = Sequence[Tuple[int, int]]  # [(batch_size, repetitions), ...]


def default_batches(n_rows: int, p: int) -> List[Tuple[int, int]]:
    """The reference's default batching: batches of size p
    (AutoRegression.h:56-62)."""
    return [(p, n_rows // p)]


def _batch_sizes(batches: BatchSpec) -> List[int]:
    sizes: List[int] = []
    for size, rep in batches:
        sizes.extend([size] * rep)
    return sizes


def _validate(n_rows: int, batches: BatchSpec) -> List[int]:
    sizes = _batch_sizes(batches)
    if not sizes:
        raise ValueError("Batch parameters not correctly defined")
    if sum(sizes) != n_rows:
        raise ValueError("Batch parameters not correctly defined")
    return sizes


def _embed(Xb: jax.Array, p: int) -> Tuple[jax.Array, jax.Array]:
    """Zero-padded delay embedding of one batch Xb (B, F):
    D (B-1, p, F) with D[t, k, f] = Xb[t-k, f] (t >= k), Y (B-1, F) = Xb[1:]
    (reference ComputeSubmatrix, AutoRegression.h:189-199)."""
    K = Xb.shape[0] - 1
    cols = []
    for k in range(p):
        if k >= K:
            cols.append(jnp.zeros_like(Xb[:K]))
        else:
            shifted = jnp.concatenate(
                [jnp.zeros_like(Xb[:k]), Xb[: K - k]], axis=0
            )
            cols.append(shifted)
    D = jnp.stack(cols, axis=1)  # (K, p, F)
    return D, Xb[1:]


def build_design(X, p: int, batches: Optional[BatchSpec] = None):
    """Stacked embedding over all batches: (D (K, p, F), Y (K, F)) where
    K = T - num_batches."""
    X = jnp.asarray(X)
    if X.ndim == 1:
        X = X[:, None]
    if batches is None:
        batches = default_batches(X.shape[0], p)
    sizes = _validate(X.shape[0], batches)
    Ds, Ys = [], []
    start = 0
    for size in sizes:
        D, Y = _embed(X[start : start + size], p)
        Ds.append(D)
        Ys.append(Y)
        start += size
    return jnp.concatenate(Ds, axis=0), jnp.concatenate(Ys, axis=0)


def fit_ar(X, p: int, batches: Optional[BatchSpec] = None) -> jax.Array:
    """theta (p, F): per-feature least squares over the stacked embedding
    (reference ComputeModel, AutoRegression.h:51-110)."""
    D, Y = build_design(X, p, batches)  # (K, p, F), (K, F)

    def solve_one(Df, Yf):
        # lstsq via economic SVD — the reference solves with thin BDCSVD
        theta, _, _, _ = jnp.linalg.lstsq(Df, Yf)
        return theta

    return jax.vmap(solve_one, in_axes=(2, 1), out_axes=1)(D, Y)


def predict_ar(
    X,
    theta: jax.Array,
    n: int,
    batches: Optional[BatchSpec] = None,
    one_prediction_per_batch: Optional[bool] = None,
) -> jax.Array:
    """n-step-ahead prediction (reference Predict, AutoRegression.h:112-186).

    Returns (K, F), or (num_batches, F) when ``one_prediction_per_batch``.
    With ``batches=None`` the reference's default batching applies and
    one-prediction-per-batch is forced on (AutoRegression.h:120-126)."""
    X = jnp.asarray(X)
    if X.ndim == 1:
        X = X[:, None]
    p = theta.shape[0]
    if batches is None:
        batches = default_batches(X.shape[0], p)
        # the reference forces this UNCONDITIONALLY in the default-batch
        # branch (AutoRegression.h:125 'onePredictionPerBatch = true')
        one_prediction_per_batch = True
    if one_prediction_per_batch is None:
        one_prediction_per_batch = False
    sizes = _validate(X.shape[0], batches)

    D, _ = build_design(X, p, batches)  # (K, p, F)

    # n-step rollout: YStep = D . theta (per feature), then shift YStep into
    # column 0 (reference AutoRegression.h:166-173).  n is static.
    Y = None
    for _ in range(n):
        Y = jnp.einsum("kpf,pf->kf", D, theta,
                       precision=matmul_precision())
        D = jnp.concatenate([Y[:, None, :], D[:, : p - 1, :]], axis=1)

    assert Y is not None, "n-step count must be >= 1"

    if one_prediction_per_batch:
        # reference quirk: the stride uses batchSize[0] even for
        # heterogeneous batches (AutoRegression.h:176-183)
        b0 = batches[0][0]
        n_batches = len(sizes)
        idx = jnp.asarray([(b + 1) * (b0 - 1) - 1 for b in range(n_batches)])
        return Y[idx]
    return Y


def save_ar(theta, filename: str) -> None:
    """(reference WriteModelParametersToFile, AutoRegression.h:41-44)"""
    import numpy as np

    matrixio.write_matrix(np.asarray(theta), filename)


def load_ar(filename: str, dtype=None) -> jax.Array:
    """(reference ReadModelParametersFromFile, AutoRegression.h:36-39)"""
    return jnp.asarray(matrixio.read_matrix(filename, dtype))
