"""Subtraction profile of the blocked Cholesky at n=16k.

Isolates where the recursion's time goes beyond its GEMM floor by timing
structurally-identical variants with one component knocked out at a time:

  full      cholesky_blocked as dispatched in production
  leaftril  leaf factorizations replaced by jnp.tril(A) (keeps all GEMMs
            and solves; diff vs `full` = leaf-chain cost)
  solvegemm triangular solves replaced by an equal-SHAPE GEMM
            A21 @ tril(L11) (2x the solve's flops, but at GEMM rate;
            diff vs `full` = triangular-solve inefficiency beyond GEMM)
  gemmonly  leaves AND solves knocked out: only the recursion's trailing
            updates remain — the REAL floor for this schedule's GEMM
            shapes

Wrong math everywhere except `full` — these are timing skeletons with the
same shapes/dependencies.  Run one variant per process:

    BENCH_VARIANT=full python benchmarks/bench_chol_anatomy.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _round_split(n: int, align: int = 128) -> int:
    m = n // 2
    return max(align, m - (m % align)) if m >= align else m


def main():
    import jax

    from gpr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from gpr_tpu.utils.config import matmul_precision

    variant = os.environ.get("BENCH_VARIANT", "full")
    n = int(os.environ.get("BENCH_N", 16384))
    leaf = int(os.environ.get("BENCH_LEAF", 0))
    if leaf <= 0:
        from gpr_tpu.ops.blocked import _default_leaf

        leaf = _default_leaf()
    dtype = jnp.float32

    def chol_variant(A):
        def rec(A):
            s = A.shape[0]
            if s <= leaf:
                if variant == "leaftril" or variant == "gemmonly":
                    return jnp.tril(A)
                return jnp.linalg.cholesky(A)
            m = _round_split(s)
            L11 = rec(A[:m, :m])
            A21 = A[m:, :m]
            if variant in ("solvegemm", "gemmonly"):
                L21 = jnp.matmul(
                    A21, jnp.tril(L11), preferred_element_type=A.dtype,
                    precision=matmul_precision(),
                )
            else:
                from gpr_tpu.ops.blocked import solve_triangular_blocked

                L21 = solve_triangular_blocked(L11, A21.T, leaf=leaf).T
            upd = jnp.matmul(
                L21, L21.T, preferred_element_type=A.dtype,
                precision=matmul_precision(),
            )
            S22 = A[m:, m:] - upd
            S22 = 0.5 * (S22 + S22.T)
            L22 = rec(S22)
            top = jnp.concatenate([L11, jnp.zeros((m, s - m), A.dtype)], axis=1)
            bot = jnp.concatenate([L21, L22], axis=1)
            return jnp.concatenate([top, bot], axis=0)

        return rec(A)

    rng = np.random.default_rng(0)
    B = rng.standard_normal((n, 256)).astype(np.float32)
    # well-conditioned SPD without an n^2 host transfer of a full random mat
    A = jnp.asarray(B) @ jnp.asarray(B.T) * (1.0 / 256) + 4.0 * jnp.eye(n, dtype=dtype)
    A = A.astype(dtype)

    def make_fn(repeats):
        @jax.jit
        def f(A):
            out = jnp.asarray(0.0, dtype)
            for _ in range(repeats):
                L = chol_variant(A + out * 1e-30)
                out = jnp.sum(L[-1])
            return out

        return f

    repeats = int(os.environ.get("BENCH_REPEATS", 3))
    f1, fR = make_fn(1), make_fn(repeats)
    t0 = time.perf_counter()
    float(f1(A))
    print(f"compile+run r=1: {time.perf_counter()-t0:.1f}s", file=sys.stderr)
    t0 = time.perf_counter()
    float(fR(A))
    print(f"compile+run r={repeats}: {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    def best_of(f, iters=3):
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            float(f(A))
            best = min(best, time.perf_counter() - t0)
        return best

    t1, tR = best_of(f1), best_of(fR)
    per = max((tR - t1) / (repeats - 1), 1e-9)
    print(
        json.dumps(
            {
                "variant": variant,
                "n": n,
                "leaf": leaf,
                "seconds": round(per, 5),
                "t1": round(t1, 5),
                "tR": round(tR, 5),
            }
        )
    )


if __name__ == "__main__":
    main()
