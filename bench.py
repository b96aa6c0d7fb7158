"""Headline benchmark: one exact-GP fit (Gram + Cholesky + solve) on one GPU.

Times the public training entry point ``gpr_tpu.fit`` (jitted) at the
north-star size n=16384, d=128, q=8 in float32 — the reference's learning
hot path (lib/GaussianProcess.cpp:641-672: O(n^2 d) Gram build + O(n^3)
factorization + solves).  Each timed call ends in ``block_until_ready``;
the result is the median of ``BENCH_REPEATS`` calls after one warm-up.

    python bench.py            # BENCH_N, BENCH_REPEATS override the size/count

Prints the card's name and power limit (``nvidia-smi``), then ONE JSON line
with the fit time, the achieved rate under the flop model below, and the
device as JAX reports it.  Exits non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def time_call(fn, *args, iters: int = 5) -> float:
    """Median seconds of ``fn(*args)`` over ``iters`` calls after one
    warm-up call; each call ends in ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def fit_flops(n: int, d: int, q: int) -> float:
    """Gram GEMM 2 n^2 d + Cholesky n^3 / 3 + two triangular solves 2 n^2 q."""
    return 2.0 * n * n * d + n**3 / 3.0 + 2.0 * n * n * q


def main() -> int:
    from gpr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax
    import jax.numpy as jnp

    import gpr_tpu

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (first device is {dev.platform})", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)

    n = int(os.environ.get("BENCH_N", 16384))
    repeats = int(os.environ.get("BENCH_REPEATS", 10))
    d, q = 128, 8
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    Y = jnp.asarray(rng.standard_normal((n, q)), jnp.float32)
    kernel = gpr_tpu.Gaussian(jnp.float32(8.0), jnp.float32(1.0))
    sigma = jnp.float32(0.1)

    fit = jax.jit(gpr_tpu.fit)
    t0 = time.perf_counter()
    jax.block_until_ready(fit(kernel, X, Y, sigma))
    t_first = time.perf_counter() - t0
    t_fit = time_call(fit, kernel, X, Y, sigma, iters=repeats)

    print(json.dumps({
        "metric": f"gp_fit_n{n}_d{d}_q{q}_f32",
        "fit_seconds": t_fit,
        "first_call_seconds": t_first,
        "achieved_tflops": fit_flops(n, d, q) / t_fit / 1e12,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "nvidia_smi": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
