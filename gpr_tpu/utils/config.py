"""Global dtype / precision policy for gpr_tpu.

The reference library (agiger/GPR) is templated over float/double and mixes
long-double for determinants (reference: include/Likelihood.h:48,111). Here
a two-tier policy:

  * ``parity``  — float64 everywhere (requires ``jax_enable_x64``); used by the
    golden tests that reproduce the reference's numerical results.
  * ``fast``    — float32 master arrays; the production accelerator path.

The policy only controls *defaults*; every public function also accepts
explicit ``dtype=`` overrides.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class Policy:
    name: str
    default_dtype: jnp.dtype
    # dtype matmuls accumulate in
    accum_dtype: jnp.dtype


_FAST = Policy(name="fast", default_dtype=jnp.float32, accum_dtype=jnp.float32)
_PARITY = Policy(name="parity", default_dtype=jnp.float64, accum_dtype=jnp.float64)

_active = _FAST


def enable_x64() -> None:
    """Turn on float64 support process-wide (needed for the parity policy)."""
    jax.config.update("jax_enable_x64", True)


def set_policy(name: str) -> Policy:
    global _active
    if name == "fast":
        _active = _FAST
    elif name == "parity":
        enable_x64()
        _active = _PARITY
    else:
        raise ValueError(f"unknown policy {name!r}; expected 'fast' or 'parity'")
    return _active


def policy() -> Policy:
    return _active


def default_dtype() -> jnp.dtype:
    return _active.default_dtype


@contextlib.contextmanager
def policy_scope(name: str):
    global _active
    prev = _active
    try:
        set_policy(name)
        yield _active
    finally:
        _active = prev


# ---------------------------------------------------------------------------
# matmul precision policy
# ---------------------------------------------------------------------------
# Every contraction of the numerics core (Gram GEMM, blocked-Cholesky
# trailing updates and panel solves, prediction GEMVs) passes
# ``precision=matmul_precision()``.  On a GPU with tensor cores, float32
# dots at jax's "default" and "high" tiers both run in TF32 (10-bit
# mantissa, ~1e-3 relative error): too coarse for the cancelling
# |x|^2 + |y|^2 - 2 x.y Gram identity and for the trailing Schur updates,
# where it can fail pivots and make ``safe_cholesky`` add jitter.  The
# default is therefore "highest" (full float32).  Besides the three tiers,
# the name of any ``jax.lax.DotAlgorithmPreset`` (e.g. "BF16_BF16_F32_X3",
# "TF32_TF32_F32_X3") selects that dot algorithm; such presets take float32
# operands only.  The measured error and rate of each on the card are in
# PERF.md.

_TIERS = ("default", "high", "highest")
_matmul_precision = "highest"


def _resolve(p: str):
    if p in _TIERS:
        return p
    try:
        return jax.lax.DotAlgorithmPreset[p]
    except KeyError:
        raise ValueError(f"unknown matmul precision {p!r}") from None


def set_matmul_precision(p: str) -> None:
    """Set the core's contraction precision: a tier name or the name of a
    ``jax.lax.DotAlgorithmPreset``."""
    global _matmul_precision
    _resolve(p)
    _matmul_precision = p


def matmul_precision():
    """The ``precision=`` argument every core contraction passes: the tier
    string, or the ``DotAlgorithmPreset`` a preset name maps to."""
    return _resolve(_matmul_precision)
