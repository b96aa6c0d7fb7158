"""Worker process for the multi-process (DCN-analog) collective test.

Launched by tests/test_multiprocess.py as
    python tests/mp_worker.py <coordinator> <num_procs> <proc_id> <outdir>
with xla_force_host_platform_device_count = 8/num_procs: the processes
form one 8-device global mesh whose cross-process collectives ride the
distributed runtime (gRPC) — the code path cross-host collectives take
on a real multi-host cluster (SURVEY.md §5.8; the reference has no
distributed story at all, scripts/main.py drives processes via os.system
+ files).  With num_procs=1 it produces the single-process reference
result in an otherwise IDENTICAL environment (same dtype policy, same
binary), so the test isolates exactly the process topology.
"""

import os
import sys


def main():
    coordinator, num_procs, proc_id, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )

    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={8 // num_procs}"
    )
    import jax

    # the test runs on the CPU backend, as conftest.py forces in-process
    jax.config.update("jax_platforms", "cpu")
    if num_procs > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_procs,
            process_id=proc_id,
        )

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = jax.devices()  # global: 8 across all processes
    assert len(devs) == 8, devs
    mesh = Mesh(np.array(devs), ("chains",))

    # 1) cross-process psum correctness
    x = jnp.arange(8, dtype=jnp.float32)
    xs = jax.device_put(x, NamedSharding(mesh, P("chains")))
    total = jax.jit(
        jax.shard_map(
            lambda v: jax.lax.psum(jnp.sum(v), "chains"),
            mesh=mesh, in_specs=P("chains"), out_specs=P(),
        )
    )(xs)
    psum_val = float(np.asarray(total)[()] if total.ndim == 0 else total[0])

    # 2) sharded HMC over the 2-process mesh (cross-chain adaptation
    # statistics cross the process boundary via psum/pmean)
    import gpr_tpu
    from gpr_tpu.gp import likelihood as lk
    from gpr_tpu.parallel import sharded_hmc
    from gpr_tpu.inference import hmc as hmc_mod

    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((32, 2)).astype(np.float32))
    Y = jnp.asarray(np.sin(np.asarray(X).sum(-1, keepdims=True)).astype(np.float32))

    def logp(z):
        k = gpr_tpu.Gaussian(jnp.exp(z[0]), jnp.exp(z[1]))
        return lk.mll_scalar(k, X, Y, sigma=0.3)

    z0 = jnp.asarray(rng.standard_normal((8, 2)).astype(np.float32) * 0.1)
    cfg = hmc_mod.HMCConfig(
        num_samples=8, num_warmup=8, num_leapfrog=4, initial_step_size=0.05
    )
    res = sharded_hmc.sample_hmc_sharded(
        logp, z0, jax.random.PRNGKey(0), cfg, mesh=mesh
    )

    from jax.experimental import multihost_utils

    samples = multihost_utils.process_allgather(res.samples, tiled=True)

    if proc_id == 0:
        np.savez(
            os.path.join(outdir, f"mp_result_np{num_procs}.npz"),
            psum=psum_val,
            samples=np.asarray(samples),
            step_size=np.asarray(res.step_size),
        )
    if num_procs > 1:
        jax.distributed.shutdown()


if __name__ == "__main__":
    main()
