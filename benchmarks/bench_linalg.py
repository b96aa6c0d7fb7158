"""Precision tiers and factorization routes of the exact-GP core on one GPU.

Two tables, printed as JSON lines:

* ``precision``: for every contraction precision the core can be set to
  (``utils.config.set_matmul_precision``: the tiers default / high /
  highest and the ``jax.lax.DotAlgorithmPreset`` names), the relative error
  against float64 and the rate of an m=4096 float32 matmul, and the alpha
  and L errors, jitter and time of the headline fit (``gpr_tpu.fit``,
  n=16384, d=128, q=8) built at that precision.  A preset the compiler
  refuses is reported with its error.
* ``cholesky``: the recursive blocked Cholesky (``ops.blocked``, what
  ``safe_cholesky`` runs from n=1024) against one ``jnp.linalg.cholesky``
  call (the vendor ``potrf``) at n=3773 and n=16384, with a leaf sweep, and
  the blocked against the stock triangular-solve ``cho_solve``.

Errors are max-abs over max-abs of the float64 reference; times are the
median of block_until_ready calls (bench.py::time_call).

    python benchmarks/bench_linalg.py [--fit-n 16384] [--chol-n 3773,16384]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import fit_flops, time_call  # noqa: E402

PRECISIONS = [
    "default", "high", "highest", "BF16_BF16_F32", "BF16_BF16_F32_X3",
    "BF16_BF16_F32_X6", "BF16_BF16_F32_X9", "TF32_TF32_F32",
    "TF32_TF32_F32_X3", "F32_F32_F32",
]


def _emit(**row) -> None:
    print(json.dumps(row), flush=True)


def _rel(jnp, a, ref):
    return float(jnp.max(jnp.abs(a.astype(jnp.float64) - ref))
                 / jnp.max(jnp.abs(ref)))


def precision_table(fit_n: int, m: int = 4096) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import gpr_tpu
    from gpr_tpu.kernels import kernels as kermod
    from gpr_tpu.ops import linalg
    from gpr_tpu.utils import config

    from chip_smoke import _reference_fit

    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.standard_normal((m, m)), jnp.float32)
    B = jnp.asarray(rng.standard_normal((m, m)), jnp.float32)
    d, q, ell, noise = 128, 8, 8.0, 0.1
    X = jnp.asarray(rng.standard_normal((fit_n, d)), jnp.float32)
    Y = jnp.asarray(rng.standard_normal((fit_n, q)), jnp.float32)
    kernel = gpr_tpu.Gaussian(jnp.float32(ell), jnp.float32(1.0))
    sigma = jnp.float32(noise)
    with jax.enable_x64(True):
        C64 = jnp.matmul(A.astype(jnp.float64), B.astype(jnp.float64))
        L64, a64 = jax.jit(_reference_fit)(
            X.astype(jnp.float64), Y.astype(jnp.float64), ell, 1.0, noise)

    for name in PRECISIONS:
        config.set_matmul_precision(name)
        p = config.matmul_precision()
        row = {"table": "precision", "precision": name}
        try:
            mm = jax.jit(lambda a, b: jnp.matmul(a, b, precision=p))
            C = mm(A, B)
            with jax.enable_x64(True):
                row["matmul_m"] = m
                row["matmul_rel_err"] = _rel(jnp, C, C64)
            t = time_call(mm, A, B, iters=10)
            row["matmul_tflops"] = 2.0 * m**3 / t / 1e12
        except Exception as e:  # a preset the compiler refuses
            row["matmul_refused"] = f"{type(e).__name__}: {str(e)[:200]}"
        try:
            fit = jax.jit(lambda k, X, Y, s: gpr_tpu.fit(k, X, Y, s))
            gp = fit(kernel, X, Y, sigma)
            jitter = jax.jit(lambda X: linalg.safe_cholesky(
                linalg.add_diagonal(kermod.gram(kernel, X), sigma**2))[1])(X)
            with jax.enable_x64(True):
                row["fit_n"] = fit_n
                row["fit_alpha_rel_err"] = _rel(jnp, gp.alpha, a64)
                row["fit_L_rel_err"] = _rel(jnp, gp.L, L64)
            row["fit_jitter"] = float(jitter)
            del gp
            t = time_call(fit, kernel, X, Y, sigma, iters=10)
            row["fit_seconds"] = t
            row["fit_tflops"] = fit_flops(fit_n, d, q) / t / 1e12
        except Exception as e:
            row["fit_refused"] = f"{type(e).__name__}: {str(e)[:200]}"
        _emit(**row)
    config.set_matmul_precision("highest")


def cholesky_table(sizes) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import gpr_tpu
    from gpr_tpu.kernels import kernels as kermod
    from gpr_tpu.ops import linalg
    from gpr_tpu.ops.blocked import cho_solve_blocked, cholesky_blocked

    for n in sizes:
        rng = np.random.default_rng(n)
        X = jnp.asarray(rng.standard_normal((n, 16)), jnp.float32)
        A = linalg.add_diagonal(
            kermod.gram(gpr_tpu.Gaussian(jnp.float32(4.0)), X), 0.01)
        Yq = jnp.asarray(rng.standard_normal((n, 8)), jnp.float32)
        with jax.enable_x64(True):
            L64 = jnp.linalg.cholesky(A.astype(jnp.float64))
        routes = {
            "potrf (jnp.linalg.cholesky)": jnp.linalg.cholesky,
            "safe_cholesky (fit's route)": lambda A: linalg.safe_cholesky(A)[0],
        }
        for leaf in (256, 512, 1024, 2048):
            routes[f"blocked leaf={leaf}"] = (
                lambda A, leaf=leaf: cholesky_blocked(A, leaf=leaf))
        for name, fn in routes.items():
            f = jax.jit(fn)
            L = f(A)
            with jax.enable_x64(True):
                err = _rel(jnp, jnp.tril(L), L64)
            t = time_call(f, A, iters=10)
            _emit(table="cholesky", n=n, route=name, seconds=t,
                  tflops=n**3 / 3.0 / t / 1e12, L_rel_err=err)
        L = jnp.linalg.cholesky(A)
        for name, fn in {
            "cho_solve_blocked": cho_solve_blocked,
            "jax.scipy cho_solve (trsm)": lambda L, B: jax.scipy.linalg.cho_solve(
                (L, True), B),
        }.items():
            f = jax.jit(fn)
            t = time_call(f, L, Yq, iters=10)
            _emit(table="solve", n=n, q=8, route=name, seconds=t)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fit-n", type=int, default=16384)
    ap.add_argument("--chol-n", default="3773,16384")
    args = ap.parse_args()
    from gpr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_linalg: no GPU (first device is {dev.platform})",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    _emit(device=dev.device_kind, nvidia_smi=smi, jax=jax.__version__)
    precision_table(args.fit_n)
    cholesky_table([int(s) for s in args.chol_n.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
