"""Batched many-GP fleet throughput (1 device): fits/s for B small GPs.

Batched Gram + batched Cholesky (SURVEY.md §7), timed as the median of
block_until_ready calls (bench.py::time_call).
    python benchmarks/bench_batched.py [B] [n]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from bench import time_call
    from gpr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax
    import jax.numpy as jnp

    import gpr_tpu
    from gpr_tpu.gp import batched

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 512
    d, q = 8, 4

    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((B, n, d)).astype(np.float32))
    Y = jnp.asarray(rng.standard_normal((B, n, q)).astype(np.float32))
    kernel = gpr_tpu.Gaussian(jnp.float32(2.0), jnp.float32(1.0))

    fit = jax.jit(
        lambda X, Y: batched.fit_batched(kernel, X, Y, sigma=0.1).alpha
    )
    per = time_call(fit, X, Y)
    flops = B * (2 * n * n * d + n**3 / 3 + 2 * n * n * q)
    print(
        json.dumps(
            {
                "metric": f"batched_gp_fits_per_sec_B{B}_n{n}",
                "value": round(B / per, 1),
                "unit": "fits/s",
                "detail": {
                    "device": {"platform": jax.devices()[0].platform,
                               "kind": jax.devices()[0].device_kind},
                    "tflops": round(flops / per / 1e12, 2),
                    "seconds_per_batch": round(per, 5),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
