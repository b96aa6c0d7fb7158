"""End-to-end chunked NUTS throughput on the published GP-hyperparameter
posterior — the NUTS counterpart of bench_hmc_e2e.py (draws/s is not
directly comparable to HMC samples/s: each NUTS transition costs a
variable-depth trajectory of up to 2^max_depth leapfrogs).

    python benchmarks/bench_nuts_e2e.py [n_data]
"""

from __future__ import annotations

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from gpr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    import gpr_tpu
    from gpr_tpu.inference import nuts

    from gpr_tpu.kernels import kernels as kermod

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    W = int(os.environ.get("GPR_E2E_WARMUP", 128))
    S = int(os.environ.get("GPR_E2E_SAMPLES", 32))
    chunk = int(os.environ.get("GPR_E2E_CHUNK", 16))
    depth = int(os.environ.get("GPR_NUTS_DEPTH", 6))

    rng = np.random.default_rng(0)
    X = jnp.asarray(np.linspace(0, 10, n)[:, None].astype(np.float32))
    Y = jnp.asarray(
        (np.sin(np.linspace(0, 10, n)) + 0.1 * rng.standard_normal(n))
        .astype(np.float32)[:, None]
    )
    kernel = gpr_tpu.Gaussian(jnp.float32(1.0), jnp.float32(1.0))

    def logp(z):
        theta = jnp.exp(z)
        k = kernel.with_params(list(theta))
        K = kermod.gram(k, X)
        K = K.at[jnp.arange(n), jnp.arange(n)].add(0.1**2)
        L = jnp.linalg.cholesky(K)
        alpha = jax.scipy.linalg.cho_solve((L, True), Y)
        return (
            -0.5 * jnp.sum(Y * alpha)
            - jnp.sum(jnp.log(jnp.diagonal(L)))
            + jnp.sum(z)
        )

    cfg = nuts.NUTSConfig(num_warmup=W, num_samples=S, max_depth=depth)
    key = jax.random.PRNGKey(0)
    rows = []
    for chains in (8,):
        z0 = jnp.zeros((chains, 2), jnp.float32)
        r = nuts.sample_nuts_chunked(logp, z0, key, cfg, chunk_size=chunk)
        float(r.samples[0, -1, 0])
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            r = nuts.sample_nuts_chunked(logp, z0, key, cfg, chunk_size=chunk)
            float(r.samples[0, -1, 0])
            best = min(best, time.perf_counter() - t0)
        rows.append({
            "chains": chains, "seconds": round(best, 3),
            "draws_per_s": round(chains * (W + S) / best, 1),
            "max_depth": depth,
        })
        print(json.dumps(rows[-1]))
    print(json.dumps({"config": {"n": n, "warmup": W, "samples": S,
                                 "chunk": chunk}, "rows": rows}))


if __name__ == "__main__":
    main()
