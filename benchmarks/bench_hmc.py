"""HMC/NUTS samples-per-second on a GP hyperparameter posterior (1 device).

Measures the post-warmup sampling throughput of vmapped chains — the
BASELINE.json "samples/s at 1 chip" figure.  Usage:
    python benchmarks/bench_hmc.py [n_data] [chains]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from gpr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax
    import jax.numpy as jnp

    import gpr_tpu
    from gpr_tpu.inference import hmc as hmc_mod

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    chains = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    T = int(os.environ.get('BENCH_HMC_T', 64))  # draws per timed segment

    rng = np.random.default_rng(0)
    X = jnp.asarray(np.linspace(0, 10, n)[:, None].astype(np.float32))
    Y = jnp.asarray(
        (np.sin(np.linspace(0, 10, n)) + 0.1 * rng.standard_normal(n)).astype(
            np.float32
        )[:, None]
    )
    kernel = gpr_tpu.Gaussian(jnp.float32(1.0), jnp.float32(1.0))
    from gpr_tpu.kernels import kernels as kermod

    # direct-cholesky MLL (no jitter-escalation while_loop: that control
    # flow compiles slowly when nested under grad+vmap+scan over the
    # remote-compile path)
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
    logp_grad = jax.value_and_grad(logp)
    cfg = hmc_mod.HMCConfig(num_leapfrog=16, jitter_steps=False)

    z0 = jnp.zeros((chains, 2), jnp.float32)
    states = hmc_mod.init_chains(logp, z0)
    eps = jnp.float32(0.05)
    inv_mass = jnp.ones((2,), jnp.float32)

    def make(segments):
        # PYTHON-UNROLLED transitions (the chunked samplers' contract, see
        # inference/hmc.py::sample_hmc_chunked); T is kept small accordingly.
        @jax.jit
        def run(states, key):
            k = key
            for _ in range(segments * T):
                k, sub = jax.random.split(k)
                ks = jax.random.split(sub, chains)
                states, _ = jax.vmap(
                    lambda s, kk: hmc_mod._hmc_transition(
                        logp_grad, s, kk, eps, inv_mass, cfg
                    )
                )(states, ks)
            return jnp.sum(states.z)

        return run

    f1, f4 = make(1), make(2)
    key = jax.random.PRNGKey(0)
    float(f1(states, key)); float(f4(states, key))

    def best(f):
        b = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            float(f(states, key))
            b = min(b, time.perf_counter() - t0)
        return b

    per_seg = best(f4) - best(f1)
    sps = chains * T / per_seg
    print(
        json.dumps(
            {
                "metric": f"hmc_samples_per_sec_n{n}_c{chains}",
                "value": round(sps, 1),
                "unit": "samples/s",
                "detail": {
                    "backend": jax.default_backend(),
                    "leapfrog": cfg.num_leapfrog,
                    "grad_evals_per_sec": round(sps * cfg.num_leapfrog, 1),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
