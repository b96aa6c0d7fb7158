"""Per-frame serving latency at breathing-trace scale (VERDICT r3 #8).

Measures the real-time path the reference times per frame
(reference apps/GaussianProcessPredict.cpp:185-194: one GP predict +
credible interval per arriving ultrasound frame) through THIS repo's
one-dispatch serve pipeline (apps/serve.py: feature projection + predict
+ CI + reconstruction as ONE jitted program, one fetch per frame).

Two numbers:

* device-side per-frame time — slope of R-chained executions, the
  on-device cost of the serve program;
* end-to-end per-frame p50/p99 — wall clock of dispatch + fetch per
  frame, what a caller of the serve loop observes.

GP scale: n = 3773 training samples (the reference's breathing1D.mat
fixture length), d = 5 input modes, q = 3 output modes — the PMB-study
shape class.  Run:

    python benchmarks/bench_serve.py            # n=3773 default
    BENCH_SERVE_N=1024 python benchmarks/bench_serve.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from gpr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax
    import jax.numpy as jnp

    import gpr_tpu
    from gpr_tpu.gp import exact

    n = int(os.environ.get("BENCH_SERVE_N", 3773))
    d, q = 5, 3
    dtype = jnp.float32
    rng = np.random.default_rng(0)

    fixture = "/root/reference/tests/data/breathing1D.mat"
    if os.path.exists(fixture) and n == 3773:
        from gpr_tpu.utils import matrixio

        sig = np.asarray(matrixio.read_matrix(fixture)).ravel()[:n]
        sig = (sig - sig.mean()) / sig.std()
        # surrogate features: delay-embedded breathing signal (the serve
        # path's input-PCA features are exactly such low-d respiratory
        # coordinates)
        X = np.stack([np.roll(sig, k) for k in range(d)], axis=1)
        Y = np.stack([np.roll(sig, -k - 1) for k in range(q)], axis=1)
        src = "breathing1D"
    else:
        X = rng.standard_normal((n, d))
        Y = rng.standard_normal((n, q))
        src = "synthetic"

    X = jnp.asarray(X, dtype)
    Y = jnp.asarray(Y, dtype)
    kernel = gpr_tpu.Gaussian(jnp.asarray(2.0, dtype), jnp.asarray(1.0, dtype))
    print(f"bench_serve: fitting n={n} d={d} q={q} ({src})", file=sys.stderr)
    gp = exact.fit(kernel, X, Y, sigma=0.1)
    jax.block_until_ready(gp.alpha)

    # the serve per-frame program: predict + credible interval, one packed
    # output vector (apps/serve.py::Server.pipe without the PCA wings —
    # their cost is O(modes) and host-side negligible)
    @jax.jit
    def frame(gp, x):
        mean = gp.predict(x[None, :])
        ci = gp.credible_interval(x[None, :])
        return jnp.concatenate(
            [jnp.reshape(mean, (-1,)), jnp.reshape(ci, (-1,))]
        )

    xs = jnp.asarray(rng.standard_normal((256, d)), dtype)
    np.asarray(frame(gp, xs[0]))  # compile + warm

    # --- device-side per-frame: R-chained executions, slope -----------------
    def make_chain(r):
        @jax.jit
        def ch(gp, x):
            out = jnp.zeros((q + 1,), dtype)
            for i in range(r):
                out = out + frame(gp, x + out[0] * 1e-30)
            return out[0]

        return ch

    c1, cR = make_chain(1), make_chain(8)
    float(c1(gp, xs[0])); float(cR(gp, xs[0]))
    t1 = min(
        (lambda t0: (float(c1(gp, xs[0])), time.perf_counter() - t0)[1])(
            time.perf_counter()
        )
        for _ in range(5)
    )
    tR = min(
        (lambda t0: (float(cR(gp, xs[0])), time.perf_counter() - t0)[1])(
            time.perf_counter()
        )
        for _ in range(5)
    )
    dev_per_frame = max((tR - t1) / 7.0, 1e-9)

    # --- end-to-end per-frame (dispatch + fetch), p50/p99 -------------------
    lat = []
    for i in range(100):
        t0 = time.perf_counter()
        np.asarray(frame(gp, xs[i % 256]))
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat)
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))

    print(json.dumps({
        "metric": f"serve_per_frame_n{n}",
        "device_per_frame_us": round(dev_per_frame * 1e6, 1),
        "e2e_p50_ms": round(p50 * 1e3, 3),
        "e2e_p99_ms": round(p99 * 1e3, 3),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind},
        "source": src,
    }))


if __name__ == "__main__":
    main()
