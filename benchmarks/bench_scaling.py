"""Multi-device sampler scaling harness — samples/s and parallel
efficiency per device count (SURVEY.md §5.8).

Weak scaling: chains-per-device held fixed, the chain axis sharded over a
1-D mesh via `sample_hmc_sharded_chunked` (the multi-device production
path).  On several GPUs this reports the scaling; on the virtual CPU mesh
(GPR_SCALING_BACKEND=cpu forces --xla_force_host_platform_device_count=8)
it only validates the harness, sharding and efficiency accounting.

Prints one JSON line per device count:
  {"devices": N, "chains": C, "samples_per_s": S, "efficiency": E}
and a summary line; writes the summary to $GPR_SCALING_OUT when set.

    python benchmarks/bench_scaling.py [chains_per_device] [n_data]
"""

from __future__ import annotations

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

if os.environ.get("GPR_SCALING_BACKEND", "") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import numpy as np  # noqa: E402


def main():
    import jax

    if os.environ.get("GPR_SCALING_BACKEND", "") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from gpr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    import jax.numpy as jnp

    import gpr_tpu
    from gpr_tpu.gp import likelihood as lk
    from gpr_tpu.inference import hmc
    from gpr_tpu.parallel import sharded_hmc

    chains_per_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    T = int(os.environ.get("GPR_SCALING_T", 128))
    chunk = int(os.environ.get("GPR_SCALING_CHUNK", 64))

    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((n, 4)).astype(np.float32))
    Y = jnp.asarray(
        np.sin(np.asarray(X).sum(-1, keepdims=True)).astype(np.float32)
    )

    def logp(z):
        k = gpr_tpu.Gaussian(jnp.exp(z[0]), jnp.exp(z[1]))
        return lk.mll_scalar(k, X, Y, sigma=jnp.exp(z[2]))

    # post-warmup throughput (the BASELINE metric): minimal warmup
    # (num_warmup=0 leaves two 1-step adaptation stages), fixed leapfrog
    # count — the same chunk program the production sampler runs after
    # its warmup stages
    cfg = hmc.HMCConfig(
        num_samples=T, num_warmup=0, num_leapfrog=8,
        initial_step_size=0.02, jitter_steps=False,
    )
    key = jax.random.PRNGKey(0)

    n_avail = len(jax.devices())
    counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n_avail]
    rows = []
    sps_by_dev = {}
    for n_dev in counts:
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:n_dev]), ("chains",)
        )
        chains = chains_per_dev * n_dev
        z0 = jnp.asarray(
            rng.standard_normal((chains, 3)).astype(np.float32) * 0.1
        )

        def run():
            r = sharded_hmc.sample_hmc_sharded_chunked(
                logp, z0, key, cfg, chunk_size=chunk, mesh=mesh
            )
            float(r.samples[0, -1, 0])  # force completion
            return r

        run()  # compile + warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        sps = chains * T / best
        sps_by_dev[n_dev] = sps
        base = sps_by_dev[1]
        eff = sps / (base * n_dev)
        rows.append({
            "devices": n_dev,
            "chains": chains,
            "samples_per_s": round(sps, 1),
            "efficiency": round(eff, 4),
            "seconds": round(best, 4),
        })
        print(json.dumps(rows[-1]))

    eff = sharded_hmc.chain_scaling_efficiency(sps_by_dev)
    summary = {
        "backend": jax.default_backend(),
        "chains_per_device": chains_per_dev,
        "n_data": n,
        "transitions": T,
        "rows": rows,
        "efficiency_vs_linear": {str(k): round(v, 4) for k, v in eff.items()},
    }
    if jax.default_backend() == "cpu":
        summary["note"] = (
            "virtual CPU mesh: all 'devices' share one host's cores, so "
            "efficiency-vs-linear is NOT meaningful here — this run "
            "validates the harness/sharding; run on real multi-chip "
            "hardware for the scaling figure"
        )
    out = os.environ.get("GPR_SCALING_OUT")
    if out:
        with open(out, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps({"written": out, "efficiency": summary["efficiency_vs_linear"]}))


if __name__ == "__main__":
    main()
