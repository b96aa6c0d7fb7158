"""Multi-process (2-'host') collective validation — the DCN-analog test.

Spawns two real OS processes that form one jax.distributed cluster (CPU
backend, 4 virtual devices each = a global 8-device mesh across a process
boundary).  Cross-process collectives run over the distributed runtime's
gRPC/Gloo transport — the mechanism cross-host collectives use on a
multi-host cluster, which cannot be exercised in-process with virtual
devices alone.

Validates SURVEY.md §5.8's rebuild contract: jax.distributed bring-up,
psum across hosts, and sharded-HMC chains whose cross-chain adaptation
statistics (pmean'd acceptance, psum'd mass moments) cross the host
boundary, agreeing with a single-process 8-device run of the SAME worker
binary (so the only varying factor is the process topology).

Reference: the reference has NO distributed backend (its inter-process
transport is os.system + files, scripts/main.py:269-330); this subsystem
is rebuild-only.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(coordinator, num_procs, proc_id, outdir):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_NUM_PROCESSES", None)
    worker = os.path.join(root, "tests", "mp_worker.py")
    return subprocess.Popen(
        [sys.executable, worker, coordinator, str(num_procs), str(proc_id),
         str(outdir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )


def _wait_all(procs):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("workers timed out\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"


@pytest.mark.slow
def test_two_process_mesh_matches_single_process(tmp_path):
    coordinator = f"127.0.0.1:{_free_port()}"
    _wait_all([_launch(coordinator, 2, i, tmp_path) for i in range(2)])
    _wait_all([_launch("none", 1, 0, tmp_path)])

    two = np.load(tmp_path / "mp_result_np2.npz")
    one = np.load(tmp_path / "mp_result_np1.npz")

    # psum across the process boundary: sum(arange(8)) = 28
    assert float(two["psum"]) == pytest.approx(28.0)
    assert float(one["psum"]) == pytest.approx(28.0)

    # identical per-device programs + deterministic 8-way reductions: the
    # 2-process mesh must reproduce the single-process chains (float32
    # tolerance absorbs cross-transport reduction-order differences)
    np.testing.assert_allclose(
        two["samples"], one["samples"], rtol=2e-4, atol=2e-5
    )
    np.testing.assert_allclose(
        two["step_size"], one["step_size"], rtol=2e-4, atol=0
    )
