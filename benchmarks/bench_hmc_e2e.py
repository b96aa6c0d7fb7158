"""End-to-end chunked-sampler throughput (8 chains, n=256, L=8,
direct-Cholesky GP-hyperparameter posterior — the same logp as
bench_hmc's device-rate measurement) plus the samples/s-vs-chains
scaling curve.

e2e convention: chains * total transitions (warmup + sampling) / wall
seconds of the FULL production call (sample_hmc_chunked, steady state:
second invocation, programs cached).  Prints one JSON line per chain
count and a summary line.

    python benchmarks/bench_hmc_e2e.py [n_data]
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
    from gpr_tpu.inference import hmc
    from gpr_tpu.kernels import kernels as kermod

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    W = int(os.environ.get("GPR_E2E_WARMUP", 512))
    S = int(os.environ.get("GPR_E2E_SAMPLES", 32))
    chunk = int(os.environ.get("GPR_E2E_CHUNK", 64))

    rng = np.random.default_rng(0)
    X = jnp.asarray(np.linspace(0, 10, n)[:, None].astype(np.float32))
    Y = jnp.asarray(
        (np.sin(np.linspace(0, 10, n)) + 0.1 * rng.standard_normal(n))
        .astype(np.float32)[:, None]
    )
    kernel = gpr_tpu.Gaussian(jnp.float32(1.0), jnp.float32(1.0))

    # the published posterior (bench_hmc.py): direct-Cholesky MLL
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

    cfg = hmc.HMCConfig(
        num_warmup=W, num_samples=S, num_leapfrog=8, jitter_steps=False,
    )
    key = jax.random.PRNGKey(0)
    rows = []
    for chains in (4, 8, 16, 32):
        z0 = jnp.zeros((chains, 2), jnp.float32)
        r = hmc.sample_hmc_chunked(logp, z0, key, cfg, chunk_size=chunk)
        float(r.samples[0, -1, 0])  # compile/warm all programs
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            r = hmc.sample_hmc_chunked(logp, z0, key, cfg, chunk_size=chunk)
            float(r.samples[0, -1, 0])
            best = min(best, time.perf_counter() - t0)
        sps = chains * (W + S) / best
        rows.append({
            "chains": chains, "seconds": round(best, 3),
            "samples_per_s": round(sps, 1),
            "accept": round(float(np.mean(np.asarray(r.accept_rate))), 3),
        })
        print(json.dumps(rows[-1]))

    out = {
        "config": {"n": n, "warmup": W, "samples": S, "leapfrog": 8,
                   "chunk": chunk, "posterior": "gp-hyper direct-cholesky"},
        "rows": rows,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
