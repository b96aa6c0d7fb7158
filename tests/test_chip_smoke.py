"""chip_smoke.py: each phase at tiny sizes on the CPU, the script's
reporting contract, and the refusal to run without a GPU.  The phases'
float64 references and tolerances are the ones the card run uses."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def test_device_guard_refuses_cpu():
    with pytest.raises(cs.SmokeFailure, match="no gpu"):
        cs.phase_device("gpu")


def test_cli_without_gpu_exits_nonzero_and_prints_no_ok_line():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=_cpu_env(), cwd=REPO, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_lone_script_exits_nonzero(tmp_path):
    """Copied away from the repo, the script cannot import the engine."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        env=env, cwd=tmp_path, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_phase_fit_tiny():
    r = cs.phase_fit(n=300, d=6, q=2, ell=3.0)
    assert r["jitter"] == 0.0
    assert r["alpha_err"] <= cs.TOL_FIT and r["L_err"] <= cs.TOL_FIT


def test_phase_fit_blocked_route():
    """n >= 1024 takes the recursive blocked factor and solves."""
    r = cs.phase_fit(n=1100, d=16, q=3, ell=4.0)
    assert r["alpha_err"] <= cs.TOL_FIT


def test_phase_escalation_tiny():
    assert cs.phase_escalation(n=301, d=3)["jitter"] > 0.0


def test_phase_study_tiny(tmp_path):
    r = cs.phase_study(n_train=120, n_test=12, us_shape=(12, 12),
                       dvf_shape=(3, 4, 5), n_serve=3, workdir=str(tmp_path))
    assert r["feature_err"] <= cs.TOL_STUDY
    assert r["ci_err"] <= cs.TOL_STUDY
    assert len(r["predict_latency_s"]) == 12


def test_phase_fleet_tiny():
    assert cs.phase_fleet(B=6, n=40, d=3, q=2)["alpha_err"] <= cs.TOL_FLEET


def test_phase_sampler_tiny():
    r = cs.phase_sampler(n=32, d=2, chains=2, warmup=4, samples=4)
    assert r["mll_err"] <= cs.TOL_MLL


def test_phase_multi_on_four_virtual_devices():
    assert len(jax.devices()) >= 4
    r = cs.phase_multi(n=128, d=3, n_devices=4, fleet=(8, 24, 2, 1))
    assert r["alpha_err"] <= cs.TOL_FIT
    assert r["hmc_diff"] <= cs.TOL_SAMPLER_PARITY


def _run_main(monkeypatch, capsys, fit):
    dev = jax.devices()[0]
    monkeypatch.setattr(cs, "phase_device", lambda platform="gpu": dev)
    monkeypatch.setattr(cs, "_nvidia_smi", lambda: "card, 700.00 W")
    for name in ("phase_escalation", "phase_study", "phase_fleet",
                 "phase_sampler"):
        monkeypatch.setattr(cs, name, lambda: {})
    monkeypatch.setattr(cs, "phase_fit", fit)
    rc = cs.main([])
    return rc, capsys.readouterr().out.strip().splitlines()


def test_main_prints_device_json_last(monkeypatch, capsys):
    rc, lines = _run_main(monkeypatch, capsys, lambda: {})
    assert rc == 0
    assert lines[-2].startswith("phase sampler ok")
    assert any(l.startswith("nvidia-smi: card, 700.00 W") for l in lines)
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}}


def test_main_failing_phase_exits_1_without_ok_line(monkeypatch, capsys):
    def bad():
        raise cs.SmokeFailure("alpha error 1.0")

    rc, lines = _run_main(monkeypatch, capsys, bad)
    assert rc == 1
    assert lines[-1] == "failed phases: fit"
    assert not any('"ok"' in l for l in lines)


@pytest.mark.gpu
def test_phase_fit_on_gpu(gpu_device):
    """The headline fit on the card at a quarter of the headline n."""
    with jax.default_device(gpu_device):
        r = cs.phase_fit(n=4096, d=128, q=8)
    assert r["jitter"] == 0.0 and r["alpha_err"] <= cs.TOL_FIT
