"""Sparse-GP performance: timings of the O(n m^2) Woodbury path at
production scales, and the n-crossover vs the exact O(n^3) fit.

Measures (median of block_until_ready calls, bench.py::time_call):
  fit_sparse(n, m)             training (PreComputeRegression semantics)
  sparse_mll value+grad(n, m)  the hyperparameter-optimization hot path
  exact fit(n)                 the exact path, for the crossover

Reference semantics being re-designed: SparseLikelihood Woodbury/
determinant-lemma (reference include/SparseLikelihood.h:129-150),
PreComputeRegression (include/SparseGaussianProcess.h).

    python benchmarks/bench_sparse.py            # n=16384, m=512/1024
    BENCH_N=8192 python benchmarks/bench_sparse.py 256 512
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import time_call  # noqa: E402


def main():
    from gpr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    import gpr_tpu
    from gpr_tpu.gp import exact, sparse

    n = int(os.environ.get("BENCH_N", 16384))
    ms_list = [int(a) for a in sys.argv[1:]] or [512, 1024]
    d, q = 8, 4
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    Y = jnp.asarray(rng.standard_normal((n, q)), jnp.float32)
    kernel = gpr_tpu.Gaussian(jnp.float32(2.0), jnp.float32(1.0))
    sigma = jnp.float32(0.3)

    out = {"n": n, "d": d, "q": q, "sparse": {}, "exact": {}}

    for m in ms_list:
        Z = X[:: max(1, n // m)][:m]

        def make_fit(repeats, Z=Z):
            @jax.jit
            def f(X, Y, s):
                acc = jnp.float32(0.0)
                for _ in range(repeats):
                    sgp = sparse.fit_sparse(kernel, Z, X + acc * 1e-30, Y, s, jitter=1e-4)
                    acc = jnp.sum(sgp.alpha[-1])
                return acc

            return f

        t_fit = time_call(make_fit(1), X, Y, sigma)

        def make_mllg(repeats, Z=Z):
            @jax.jit
            def f(X, Y, s):
                acc = jnp.float32(0.0)
                for _ in range(repeats):
                    def obj(logs):
                        k = gpr_tpu.Gaussian(jnp.exp(logs[0]), jnp.exp(logs[1]))
                        return sparse.sparse_mll_scalar(
                            k, Z, X + acc * 1e-30, Y, jnp.exp(logs[2]),
                            jitter=1e-4,
                        )

                    v, g = jax.value_and_grad(obj)(
                        jnp.asarray([0.7, 0.0, -1.2], jnp.float32)
                    )
                    acc = acc + v * 1e-30 + jnp.sum(g) * 1e-30 + acc
                return acc + v

            return f

        t_mllg = time_call(make_mllg(1), X, Y, sigma)
        # O(n m^2) flop model: Knm gram 2nmd + Woodbury inner n m^2 + chol m^3/3
        fl_fit = 2.0 * n * m * d + n * m * m + m**3 / 3.0
        out["sparse"][f"m{m}"] = {
            "fit_ms": round(t_fit * 1e3, 3),
            "fit_tflops": round(fl_fit / t_fit / 1e12, 2),
            "mll_value_grad_ms": round(t_mllg * 1e3, 3),
        }
        print(json.dumps({"m": m, **out["sparse"][f"m{m}"]}), file=sys.stderr)

    # exact-path crossover: the exact fit at the same n
    def make_exact(repeats):
        @jax.jit
        def f(X, Y, s):
            acc = jnp.float32(0.0)
            for _ in range(repeats):
                gp = exact.fit(kernel, X + acc * 1e-30, Y, sigma=s)
                acc = jnp.sum(gp.alpha[-1])
            return acc

        return f

    t_exact = time_call(make_exact(1), X, Y, sigma)
    out["exact"]["fit_ms"] = round(t_exact * 1e3, 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
