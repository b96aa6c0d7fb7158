"""The one compile-cache helper, and that every entry point uses it and
no code path names a cache directory of its own or branches on the
backend's name."""

import glob
import os
import re
import subprocess
import sys

import pytest

from gpr_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_names_the_directory(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_unset_uses_the_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    assert ".jax_cache/" in open(os.path.join(REPO, ".gitignore")).read()


@pytest.mark.parametrize("set_env", [True, False])
def test_setup_configures_jax(tmp_path, set_env):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop(compile_cache.ENV, None)
    want = os.path.join(REPO, ".jax_cache")
    if set_env:
        env[compile_cache.ENV] = want = str(tmp_path / "cache")
    code = (
        "import jax\n"
        "from gpr_tpu.utils.compile_cache import setup_compile_cache\n"
        "print(setup_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [want, want]


def _entry_points():
    files = [os.path.join(REPO, f) for f in ("chip_smoke.py", "bench.py")]
    files += glob.glob(os.path.join(REPO, "benchmarks", "*.py"))
    files += [os.path.join(REPO, "gpr_tpu", "apps", f"{a}.py")
              for a in ("learn", "predict", "serve", "drift", "experiments")]
    return files


@pytest.mark.parametrize("path", _entry_points(), ids=os.path.basename)
def test_entry_point_uses_the_helper(path):
    src = open(path).read()
    assert "setup_compile_cache()" in src
    assert "/tmp/gpr_tpu" not in src


def test_no_backend_gates_or_interpret_mode():
    """No branch on the backend's name, no Pallas module of another
    accelerator, no Pallas interpreter switch anywhere in the package or
    the entry points."""
    patterns = (r'default_backend\(\)\s*[!=]=\s*"t', r"pl[t]pu",
                r"pallas\.[t]pu", r"interpret=")
    files = glob.glob(os.path.join(REPO, "gpr_tpu", "**", "*.py"), recursive=True)
    files += _entry_points()
    hits = [(f, p) for f in files for p in patterns
            if re.search(p, open(f).read())]
    assert not hits, hits
