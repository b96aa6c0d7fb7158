"""Hamiltonian Monte Carlo over GP hyperparameters.

The replacement for the reference's point-estimate optimizer
(reference include/GaussianProcessInference.h:84-229 — pinv-based
Gauss-Newton on the MLL): instead of a single MAP/MLE point we sample the
full hyperparameter posterior.  One leapfrog step = one jitted
value-and-grad of the (Cholesky-based) log posterior — the O(n^3)/O(nm^2)
factorization work runs as device GEMMs and solves, and chains are embarrassingly parallel:

  * many chains per device via ``vmap``;
  * chains sharded across devices/hosts via ``shard_map`` over a
    ``jax.sharding.Mesh``, with step-size / mass-matrix adaptation
    statistics combined across ALL chains by ``psum`` collectives
    (the design target named in BASELINE.json and SURVEY.md §5.8).

Adaptation: Nesterov dual-averaging on the step size (target acceptance
0.8) and a diagonal mass matrix estimated from warmup samples, in three
jitted ``lax.scan`` stages (warmup-1: step size; warmup-2: step size under
the adapted mass; sampling).  ``sample_hmc_chunked`` runs the same
computation with every scan replaced by jitted chunks of python-unrolled
transitions, so no compiled program contains a scan-over-transition (a
compile-time workaround; whether a plain scan is now the better choice on
the GPU is an open measurement, ROADMAP Speed item 7).  The unrolled
programs fuse differently, so draws match the scan path only to rounding
over short runs; once a rounding difference flips one Metropolis accept
the chains decorrelate — same stationary distribution, different draws.

Everything is parameterized in LOG space (theta = exp(z)) so positivity is
structural; the Jacobian term sum(z) is included in the log posterior.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from ..gp import likelihood as lk


@functools.partial(jax.jit, static_argnames=("drop",))
def _shrunk_mass(zs, drop: int = 0):
    """Stan-regularized diagonal mass from warmup draws, as ONE jitted
    dispatch (the eager op-by-op form costs ~6 dispatches per warmup
    window).  ``zs``: (T, chains, dim);
    ``drop`` discards the first draws (static, baked per shape)."""
    flat = zs[drop:].reshape(-1, zs.shape[-1])
    mean = jnp.mean(flat, axis=0)
    var = jnp.mean((flat - mean) ** 2, axis=0)
    w = flat.shape[0]
    return (w / (w + 5.0)) * var + (5.0 / (w + 5.0)) * 1e-3


@jax.jit
def _da_init(eps0):
    """(mu, log_eps0) for dual averaging in one dispatch."""
    return jnp.log(10.0 * eps0), jnp.log(eps0)


def _tree_mean(v):
    """Mean of a 1-D vector with an EXPLICIT pairwise reduction order.

    ``jnp.mean`` leaves the reduction order to the compiler, which picks
    different vectorizations in different programs — the sharded chunk
    program (all_gather + mean over the global accept vector) and the
    single-device program then disagree in the last ulp of the
    dual-averaged step size, and one flipped Metropolis/multinomial
    decision later the chains decorrelate (observed with the NUTS
    transition).  An explicit balanced tree of binary adds is the same
    HLO in both programs, so the bitwise-parity contract of the sharded
    chunked samplers holds by construction rather than by luck.  The
    odd-length pad adds exact zeros."""
    n = v.shape[0]
    m = v
    while m.shape[0] > 1:
        k = m.shape[0]
        if k % 2:
            m = jnp.concatenate([m, jnp.zeros((1,), m.dtype)])
        m = m[0::2] + m[1::2]
    return m[0] / n


def _cached_program(anchor, key, build):
    """Traced/compiled chunk programs for the unrolled sampler, cached on
    the log-posterior function itself (an attribute, so the programs live
    exactly as long as the posterior; the jitted programs close over the
    posterior, which rules out a WeakKeyDictionary — the values would keep
    the keys alive).  Re-creating jax.jit objects every invocation forces
    a re-trace of each chunk program — tens of seconds for production
    chunk sizes, even when the persistent compile cache avoids XLA
    recompilation; reusing the jit object makes repeat sample_hmc_chunked
    calls execution-bound."""
    if anchor is None:
        return jax.jit(build())
    try:
        per = anchor.__dict__.setdefault("_gpr_chunk_programs", {})
    except AttributeError:  # anchor without a writable __dict__
        return jax.jit(build())
    if key not in per:
        per[key] = jax.jit(build())
    return per[key]


# ---------------------------------------------------------------------------
# log posterior builders
# ---------------------------------------------------------------------------

def make_gp_log_posterior(
    kernel, X, Y, sigma, priors: Optional[Sequence] = None, weight: float = 1.0
) -> Callable:
    """log p(z | data) over z = log(theta):
    weight * MLL(exp(z)) + sum_p log prior_p(exp(z_p)) + sum(z)  (Jacobian).
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)

    def logp(z):
        theta = jnp.exp(z)
        val = weight * lk.mll_scalar(kernel.with_params(list(theta)), X, Y, sigma)
        if priors is not None:
            for i, prior in enumerate(priors):
                if prior is not None:
                    val = val + prior.log_pdf(theta[i])
        return val + jnp.sum(z)  # change-of-variables Jacobian

    return logp


def make_sparse_gp_log_posterior(
    kernel, Z, X, Y, sigma, priors: Optional[Sequence] = None, jitter: float = 0.0
) -> Callable:
    from ..gp import sparse as sp

    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    Z = jnp.asarray(Z)

    def logp(z):
        theta = jnp.exp(z)
        val = sp.sparse_mll_scalar(
            kernel.with_params(list(theta)), Z, X, Y, sigma, jitter
        )
        if priors is not None:
            for i, prior in enumerate(priors):
                if prior is not None:
                    val = val + prior.log_pdf(theta[i])
        return val + jnp.sum(z)

    return logp


# ---------------------------------------------------------------------------
# HMC core
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HMCConfig:
    num_warmup: int = 500
    num_samples: int = 500
    num_leapfrog: int = 16
    target_accept: float = 0.8
    initial_step_size: float = 0.1
    max_step_size: float = 10.0
    jitter_steps: bool = True  # randomize leapfrog count in [1, L]
    # Stan-style expanding-window warmup: stepsize-only head, doubling
    # mass-estimation windows (each refreshes the metric AND restarts
    # dual averaging), stepsize-only tail.  Opt-in; the default two-stage
    # scheme is faster for easy posteriors.
    windowed_warmup: bool = False


class ChainState(NamedTuple):
    z: jax.Array  # position (dim,)
    logp: jax.Array  # cached log prob
    grad: jax.Array  # cached gradient


class DualAveragingState(NamedTuple):
    log_eps: jax.Array
    log_eps_bar: jax.Array
    h_bar: jax.Array
    step: jax.Array


def _leapfrog(logp_grad_fn, z, p, grad, eps, inv_mass, n_steps):
    """n_steps of leapfrog; returns (z', p', grad', logp').

    ``logp`` rides the loop carry: with traced ``n_steps``
    (cfg.jitter_steps) the fori lowers to a while-loop and XLA cannot CSE
    a post-loop re-evaluation against the final body iteration — that
    re-evaluation was one full extra O(n^3) value-and-grad per
    transition."""

    def body(_, carry):
        z, p, grad, _ = carry
        p = p + 0.5 * eps * grad
        z = z + eps * inv_mass * p
        logp, grad = logp_grad_fn(z)
        p = p + 0.5 * eps * grad
        return (z, p, grad, logp)

    # n_steps >= 1 always overwrites; derived from z (not a fresh constant)
    # so the carry's varying manual axes match the body output under
    # shard_map — same trick as safe_cholesky's jitter init
    logp0 = jnp.sum(z * 0) - jnp.inf
    z, p, grad, logp = lax.fori_loop(0, n_steps, body, (z, p, grad, logp0))
    return z, p, grad, logp


def _hmc_transition(logp_grad_fn, state: ChainState, key, eps, inv_mass, cfg: HMCConfig):
    """One HMC proposal + Metropolis accept.  Returns (state', accept_prob)."""
    k_mom, k_steps, k_acc = jax.random.split(key, 3)
    dim = state.z.shape[0]
    # momentum ~ N(0, M); with diagonal M = 1/inv_mass
    p0 = jax.random.normal(k_mom, (dim,), state.z.dtype) / jnp.sqrt(
        inv_mass.astype(state.z.dtype)
    )
    if cfg.jitter_steps:
        n_steps = jax.random.randint(k_steps, (), 1, cfg.num_leapfrog + 1)
    else:
        n_steps = cfg.num_leapfrog

    z1, p1, grad1, logp1 = _leapfrog(
        logp_grad_fn, state.z, p0, state.grad, eps, inv_mass, n_steps
    )
    ke0 = 0.5 * jnp.sum(inv_mass * p0 * p0)
    ke1 = 0.5 * jnp.sum(inv_mass * p1 * p1)
    log_accept = (logp1 - ke1) - (state.logp - ke0)
    log_accept = jnp.where(jnp.isnan(log_accept), -jnp.inf, log_accept)
    accept_prob = jnp.minimum(1.0, jnp.exp(log_accept))
    u = jax.random.uniform(k_acc, ())
    accept = u < accept_prob
    new_state = ChainState(
        z=jnp.where(accept, z1, state.z),
        logp=jnp.where(accept, logp1, state.logp),
        grad=jnp.where(accept, grad1, state.grad),
    )
    return new_state, accept_prob


class HMCResult(NamedTuple):
    samples: jax.Array  # (chains, num_samples, dim) in LOG space
    accept_rate: jax.Array  # (chains,)
    step_size: jax.Array  # final adapted step size (scalar)
    inv_mass: jax.Array  # final diagonal inverse mass (dim,)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh context that turns the chunked sampler's jitted chunk programs
    into ``shard_map``-ped programs with the chain axis sharded over
    ``mesh`` (VERDICT r1 weak #4: the python chunk loop cannot run INSIDE
    shard_map, so instead each chunk program is individually shard_mapped
    and the loop threads device-sharded chain states between them).  Chunk
    outputs come back as global arrays, so the host-level glue
    (mass estimation, concatenation) is unchanged and numerically identical
    to the single-device chunked path."""

    mesh: object  # jax.sharding.Mesh
    axis: str
    n_global: int  # total chains across the mesh

    def spec(self, *parts):
        """PartitionSpec with ``"chains"`` placeholders mapped to the mesh
        axis: spec("chains", None) -> P(<axis>, None); spec() -> P()."""
        from jax.sharding import PartitionSpec as P

        return P(*(self.axis if p == "chains" else p for p in parts))


def _split_chain_keys(key_t, n_local: int, shard_ctx: Optional[ShardCtx]):
    """Per-chain keys for one transition step.  Sharded runs split the SAME
    global key set as a single-device run and slice out this device's block,
    so chain c consumes identical randomness under every mesh layout."""
    if shard_ctx is None:
        return jax.random.split(key_t, n_local)
    all_keys = jax.random.split(key_t, shard_ctx.n_global)
    start = lax.axis_index(shard_ctx.axis) * n_local
    return lax.dynamic_slice_in_dim(all_keys, start, n_local, axis=0)


def _warmup_scan(logp_grad_fn, states, key, eps0, inv_mass, cfg, n_steps,
                 target, cross_chain_mean=None, unroll_chunk: int = 0,
                 cache_anchor=None, transition=None, shard_ctx=None,
                 transition_key=None):
    """Warmup with shared dual-averaged step size across all chains (the
    adaptation statistic is the mean acceptance over chains; with a mesh the
    mean additionally runs over devices via psum — see sample_hmc_sharded).

    ``transition(state, key, eps, inv_mass) -> (new_state, accept_stat)``
    defaults to the plain HMC transition; ``inference.nuts`` passes its own
    so dual averaging / windows / mass estimation exist exactly once
    (VERDICT r1 weak #7).

    With ``unroll_chunk > 0`` the ``lax.scan`` is replaced by jitted chunks
    of python-unrolled steps threading the dual-averaging carry — the same
    adaptation up to compiler-fusion rounding, with no scan-over-transition
    in the compiled program (see sample_hmc_chunked)."""
    custom_transition = transition is not None
    if transition is None:
        def transition(s, k, eps, im):
            return _hmc_transition(logp_grad_fn, s, k, eps, im, cfg)

    mu, log_eps0 = _da_init(eps0)
    t0, gamma, kappa = 10.0, 0.05, 0.75

    def step_fn(carry, key_t, mu=mu, inv_mass=inv_mass):
        states, log_eps, log_eps_bar, h_bar, t = carry
        keys = _split_chain_keys(key_t, states.z.shape[0], shard_ctx)
        eps = jnp.exp(log_eps)
        new_states, accept_probs = jax.vmap(
            lambda s, k: transition(s, k, eps, inv_mass)
        )(states, keys)
        if shard_ctx is not None:
            # explicitly-ordered mean over the all-gathered GLOBAL accept
            # vector — the identical reduction (same HLO adds) the
            # single-device program performs, so the dual-averaged step
            # size matches it bitwise (a hierarchical local-mean + pmean
            # rounds differently, a compiler-ordered jnp.mean only matches
            # by luck, and one flipped Metropolis decision later
            # decorrelates the chains)
            mean_accept = _tree_mean(
                lax.all_gather(accept_probs, shard_ctx.axis, tiled=True)
            )
        else:
            mean_accept = _tree_mean(accept_probs)
            if cross_chain_mean is not None:
                mean_accept = cross_chain_mean(mean_accept)
        # dual averaging
        t = t + 1.0
        eta_h = 1.0 / (t + t0)
        h_bar = (1 - eta_h) * h_bar + eta_h * (target - mean_accept)
        log_eps = mu - jnp.sqrt(t) / gamma * h_bar
        log_eps = jnp.minimum(log_eps, jnp.log(cfg.max_step_size))
        eta_x = t ** (-kappa)
        log_eps_bar = eta_x * log_eps + (1 - eta_x) * log_eps_bar
        return (new_states, log_eps, log_eps_bar, h_bar, t), (new_states.z, mean_accept)

    keys = jax.random.split(key, n_steps)
    zero = jnp.asarray(0.0, states.z.dtype)
    init = (states, log_eps0, log_eps0, zero, zero)
    if unroll_chunk > 0:
        chunk = max(1, min(unroll_chunk, n_steps))

        def make_chunk_fn(length):
            # mu / inv_mass enter as traced arguments, NOT closure
            # constants: every warmup stage then lowers to the same HLO,
            # so in-process and persistent compile caches hit across
            # stages and invocations.  The keys argument is the HOST-SLICED
            # (length, 2) chunk — passing the full key array with a traced
            # offset would key the trace on the TOTAL stage length and
            # force a fresh compile per distinct stage/invocation length
            # (seconds each, versus the microsecond async dispatch of an
            # eager slice).
            def build():
                def run(carry, keys_chunk, mu, inv_mass):
                    zs, accs = [], []
                    for t in range(length):
                        carry, (z, a) = step_fn(
                            carry, keys_chunk[t], mu=mu, inv_mass=inv_mass
                        )
                        zs.append(z)
                        accs.append(a)
                    return carry, jnp.stack(zs), jnp.stack(accs)

                if shard_ctx is None:
                    return run
                # shard the chain axis over the mesh: states are device-
                # sharded, dual-averaging scalars / keys / mass replicated
                # (the acceptance statistic is pmean'd inside step_fn, so
                # every device derives the identical step size); warmup
                # draws come back as a GLOBAL (length, n_global, dim) array
                # so the host-level mass estimation sees all chains.
                s = shard_ctx.spec
                state_spec = ChainState(
                    z=s("chains", None), logp=s("chains"), grad=s("chains", None)
                )
                carry_spec = (state_spec, s(), s(), s(), s())
                return jax.shard_map(
                    run,
                    mesh=shard_ctx.mesh,
                    in_specs=(carry_spec, s(), s(), s()),
                    out_specs=(carry_spec, s(None, "chains", None), s()),
                    check_vma=False,
                )

            ccm = None if cross_chain_mean is None else id(cross_chain_mean)
            # a custom transition needs a STABLE cache key: id() of a fresh
            # per-call closure would miss the cache every invocation and
            # leak one program set per call (sample_nuts_chunked passes
            # ("nuts", cfg))
            if not custom_transition:
                tid = None
            elif transition_key is not None:
                tid = transition_key
            else:
                tid = id(transition)
            return _cached_program(
                cache_anchor,
                ("warmup", length, states.z.shape[0], cfg, target, ccm, tid,
                 shard_ctx),
                build,
            )

        n_full, rem = divmod(n_steps, chunk)
        chunk_fn = make_chunk_fn(chunk)
        carry, zs_parts, acc_parts = init, [], []
        for c in range(n_full):
            carry, zs_c, acc_c = chunk_fn(
                carry, keys[c * chunk : (c + 1) * chunk], mu, inv_mass
            )
            zs_parts.append(zs_c)
            acc_parts.append(acc_c)
        if rem:
            carry, zs_c, acc_c = make_chunk_fn(rem)(
                carry, keys[-rem:], mu, inv_mass
            )
            zs_parts.append(zs_c)
            acc_parts.append(acc_c)
        states, log_eps, log_eps_bar, _, _ = carry
        zs = jnp.concatenate(zs_parts, axis=0)
        accepts = jnp.concatenate(acc_parts, axis=0)
    else:
        (states, log_eps, log_eps_bar, _, _), (zs, accepts) = lax.scan(step_fn, init, keys)
    return states, jnp.exp(log_eps_bar), zs, accepts


def _window_schedule(num_warmup: int):
    """(head, [window sizes], tail) — 15% stepsize head, doubling mass
    windows over the middle 75%, 10% stepsize tail (Stan's layout)."""
    head = max(int(0.15 * num_warmup), 1)
    tail = max(int(0.10 * num_warmup), 1)
    mid = max(num_warmup - head - tail, 1)
    w = max(mid // 7, 1)  # ~25/50/100 pattern at num_warmup=500
    wins = []
    rem = mid
    while rem > 0:
        take = min(w, rem)
        if rem - take < max(mid // 7, 1):
            take = rem
        wins.append(take)
        rem -= take
        w *= 2
    return head, wins, tail


def init_chains(logp_fn, z0: jax.Array) -> ChainState:
    """z0: (chains, dim) initial positions."""
    logp_grad = jax.vmap(jax.value_and_grad(logp_fn))
    logp, grad = logp_grad(z0)
    return ChainState(z=z0, logp=logp, grad=grad)


def _adapt_phase(
    logp_grad_fn,
    states: ChainState,
    k1,
    k2,
    cfg: HMCConfig,
    dim: int,
    dtype,
    cross_chain_mean: Optional[Callable],
    cross_chain_moments: Optional[Callable],
    unroll_chunk: int = 0,
    cache_anchor=None,
    transition=None,
    shard_ctx=None,
    transition_key=None,
):
    """Warmup shared by the scan, chunked AND NUTS samplers: dual-averaged
    step size + diagonal mass estimation (two-stage by default, Stan-style
    expanding windows with ``cfg.windowed_warmup``).  Consumes exactly the
    keys ``k1``/``k2`` so all samplers adapt identically given the same
    master key.  Returns (states, step_size, inv_mass)."""
    inv_mass = jnp.ones((dim,), dtype)

    def _estimate_mass(zs, drop: int = 0):
        if cross_chain_moments is None:
            # one jitted dispatch instead of ~6 eager ops
            return _shrunk_mass(zs, drop=drop)
        flat = zs[drop:].reshape(-1, dim)
        mean = jnp.mean(flat, axis=0)
        var = jnp.mean((flat - mean) ** 2, axis=0)
        w = flat.shape[0]
        # the hook combines moments across devices AND scales the draw
        # count: the Stan shrinkage weight must use the GLOBAL count or
        # a sharded run regularizes world_size-times harder than the
        # single-device run it is supposed to reproduce
        mean, var, w = cross_chain_moments(mean, var, w)
        # regularized like Stan: shrink toward unit
        return (w / (w + 5.0)) * var + (5.0 / (w + 5.0)) * 1e-3

    if cfg.windowed_warmup:
        head, wins, tail_n = _window_schedule(cfg.num_warmup)
        keys_w = jax.random.split(k1, len(wins) + 2)
        states, eps, _, _ = _warmup_scan(
            logp_grad_fn, states, keys_w[0],
            jnp.asarray(cfg.initial_step_size, dtype), inv_mass, cfg,
            head, cfg.target_accept, cross_chain_mean, unroll_chunk, cache_anchor,
            transition, shard_ctx, transition_key,
        )
        for i, win in enumerate(wins):
            states, eps, zs_w, _ = _warmup_scan(
                logp_grad_fn, states, keys_w[i + 1], eps, inv_mass, cfg,
                win, cfg.target_accept, cross_chain_mean, unroll_chunk, cache_anchor,
                transition, shard_ctx, transition_key,
            )
            inv_mass = _estimate_mass(zs_w)
        states, eps2, _, _ = _warmup_scan(
            logp_grad_fn, states, keys_w[-1], eps, inv_mass, cfg,
            tail_n, cfg.target_accept, cross_chain_mean, unroll_chunk, cache_anchor,
            transition, shard_ctx, transition_key,
        )
    else:
        n_w1 = max(cfg.num_warmup // 2, 1)
        n_w2 = max(cfg.num_warmup - n_w1, 1)

        # warmup stage 1: adapt step size under unit mass
        states, eps1, zs1, _ = _warmup_scan(
            logp_grad_fn, states, k1, jnp.asarray(cfg.initial_step_size, dtype),
            inv_mass, cfg, n_w1, cfg.target_accept, cross_chain_mean,
            unroll_chunk, cache_anchor, transition, shard_ctx, transition_key,
        )

        # mass estimation from the second half of stage-1 draws (all chains)
        inv_mass = _estimate_mass(zs1, drop=n_w1 // 2)

        # warmup stage 2: re-adapt step size under the new metric
        states, eps2, _, _ = _warmup_scan(
            logp_grad_fn, states, k2, eps1, inv_mass, cfg, n_w2,
            cfg.target_accept, cross_chain_mean, unroll_chunk, cache_anchor,
            transition, shard_ctx, transition_key,
        )

    return states, eps2, inv_mass


def sample_hmc(
    logp_fn: Callable,
    z0: jax.Array,
    key,
    cfg: HMCConfig = HMCConfig(),
    cross_chain_mean: Optional[Callable] = None,
    cross_chain_moments: Optional[Callable] = None,
) -> HMCResult:
    """Run vmapped HMC chains.  z0: (chains, dim) initial positions (log
    space).  ``cross_chain_mean`` / ``cross_chain_moments`` hooks let the
    sharded driver combine adaptation statistics across devices (psum)."""
    z0 = jnp.atleast_2d(jnp.asarray(z0))
    n_chains, dim = z0.shape
    logp_grad_fn = jax.value_and_grad(logp_fn)

    states = init_chains(logp_fn, z0)
    k1, k2, k3, k4 = jax.random.split(key, 4)

    states, eps2, inv_mass = _adapt_phase(
        logp_grad_fn, states, k1, k2, cfg, dim, z0.dtype,
        cross_chain_mean, cross_chain_moments,
    )

    # sampling
    def sample_step(states, key_t):
        keys = jax.random.split(key_t, n_chains)
        new_states, accept_probs = jax.vmap(
            lambda s, k: _hmc_transition(logp_grad_fn, s, k, eps2, inv_mass, cfg)
        )(states, keys)
        return new_states, (new_states.z, accept_probs)

    keys = jax.random.split(k3, cfg.num_samples)
    states, (zs, accepts) = lax.scan(sample_step, states, keys)

    samples = jnp.swapaxes(zs, 0, 1)  # (chains, T, dim)
    return HMCResult(
        samples=samples,
        accept_rate=jnp.mean(accepts, axis=0),
        step_size=eps2,
        inv_mass=inv_mass,
    )


def sample_hmc_chunked(
    logp_fn: Callable,
    z0: jax.Array,
    key,
    cfg: HMCConfig = HMCConfig(),
    chunk_size: int = 64,
    cross_chain_mean: Optional[Callable] = None,
    cross_chain_moments: Optional[Callable] = None,
    shard_ctx: Optional[ShardCtx] = None,
) -> HMCResult:
    """``sample_hmc`` with warmup and sampling python-unrolled in jitted
    chunks instead of ``lax.scan`` stages.

    Same math, same key flow — short runs agree with ``sample_hmc`` to
    float rounding, and long runs agree in distribution (differently-fused
    programs round differently; one flipped Metropolis decision then
    decorrelates the chains — see module docstring).  The compiler sees
    ``chunk_size`` explicit transition copies per jit rather than a scan
    over the transition.  Use this path whenever scan-of-transition
    compile time dominates; at most two programs are compiled (full chunk +
    remainder).

    With ``shard_ctx`` each chunk program is ``shard_map``-ped over the
    mesh with the chain axis device-sharded (the multi-chip production
    path — see :func:`gpr_tpu.parallel.sample_hmc_sharded_chunked`): the
    python chunk loop stays at host level, threading device-sharded chain
    states between shard_mapped programs.  Per-chain randomness is sliced
    from the same global key set, and warmup draws return as global
    arrays, so mass estimation is computed over all chains exactly as in
    the single-device run."""
    z0 = jnp.atleast_2d(jnp.asarray(z0))
    n_chains, dim = z0.shape
    logp_grad_fn = jax.value_and_grad(logp_fn)
    # clamp BEFORE warmup: chunk_size <= 0 would otherwise fall back to
    # the scan-based warmup (the slow compile this function exists to
    # avoid — and a trace error under shard_ctx)
    chunk_size = max(1, min(chunk_size, cfg.num_samples))

    states = init_chains(logp_fn, z0)
    k1, k2, k3, k4 = jax.random.split(key, 4)

    states, eps2, inv_mass = _adapt_phase(
        logp_grad_fn, states, k1, k2, cfg, dim, z0.dtype,
        cross_chain_mean, cross_chain_moments, unroll_chunk=chunk_size,
        cache_anchor=logp_fn, shard_ctx=shard_ctx,
    )

    def make_chunk_fn(length: int):
        # eps / inv_mass are traced arguments rather than closure
        # constants so repeated invocations lower to identical HLO and the
        # persistent compile cache hits (closure constants would bake the
        # adapted values into the program and force a fresh compile per
        # run).
        def build():
            def run(states, keys_chunk, eps, inv_mass):
                zs, accs = [], []
                for t in range(length):
                    states, a = jax.vmap(
                        lambda s, k: _hmc_transition(
                            logp_grad_fn, s, k, eps, inv_mass, cfg
                        )
                    )(
                        states,
                        _split_chain_keys(
                            keys_chunk[t], states.z.shape[0], shard_ctx
                        ),
                    )
                    zs.append(states.z)
                    accs.append(a)
                return states, jnp.stack(zs), jnp.stack(accs)

            if shard_ctx is None:
                return run
            s = shard_ctx.spec
            state_spec = ChainState(
                z=s("chains", None), logp=s("chains"), grad=s("chains", None)
            )
            return jax.shard_map(
                run,
                mesh=shard_ctx.mesh,
                in_specs=(state_spec, s(), s(), s()),
                out_specs=(
                    state_spec,
                    s(None, "chains", None),
                    s(None, "chains"),
                ),
                check_vma=False,
            )

        return _cached_program(
            logp_fn, ("sample", length, n_chains, cfg, shard_ctx), build
        )

    keys = jax.random.split(k3, cfg.num_samples)
    n_full, rem = divmod(cfg.num_samples, chunk_size)
    chunk_fn = make_chunk_fn(chunk_size)
    zs_parts, acc_parts = [], []
    for c in range(n_full):
        states, zs_c, acc_c = chunk_fn(
            states, keys[c * chunk_size : (c + 1) * chunk_size], eps2, inv_mass
        )
        zs_parts.append(zs_c)
        acc_parts.append(acc_c)
    if rem:
        states, zs_c, acc_c = make_chunk_fn(rem)(
            states, keys[-rem:], eps2, inv_mass
        )
        zs_parts.append(zs_c)
        acc_parts.append(acc_c)

    zs = jnp.concatenate(zs_parts, axis=0)  # (T, chains, dim)
    accepts = jnp.concatenate(acc_parts, axis=0)
    return HMCResult(
        samples=jnp.swapaxes(zs, 0, 1),
        accept_rate=jnp.mean(accepts, axis=0),
        step_size=eps2,
        inv_mass=inv_mass,
    )


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

def split_rhat(samples: jax.Array) -> jax.Array:
    """Split-R-hat per dimension.  samples: (chains, T, dim)."""
    c, t, d = samples.shape
    half = t // 2
    x = jnp.concatenate([samples[:, :half], samples[:, half : 2 * half]], axis=0)
    m, n = x.shape[0], x.shape[1]
    chain_mean = jnp.mean(x, axis=1)  # (m, d)
    chain_var = jnp.var(x, axis=1, ddof=1)  # (m, d)
    B = n * jnp.var(chain_mean, axis=0, ddof=1)
    W = jnp.mean(chain_var, axis=0)
    var_hat = (n - 1) / n * W + B / n
    return jnp.sqrt(var_hat / W)


def effective_sample_size(samples: jax.Array, max_lag: int = 100) -> jax.Array:
    """Bulk ESS per dimension via autocorrelation (Geyer initial positive
    sequence, truncated at max_lag).  samples: (chains, T, dim)."""
    c, t, d = samples.shape
    x = samples - jnp.mean(samples, axis=1, keepdims=True)
    max_lag = min(max_lag, t - 1)
    if max_lag < 1:
        # a single draw carries no autocorrelation information
        return jnp.full((d,), float(c * t), samples.dtype)

    # static python loop over lags (max_lag is a static int; XLA fuses the
    # shifted products into one program)
    acovs = jnp.stack(
        [jnp.mean(x[:, : t - lag] * x[:, lag:], axis=(0, 1)) for lag in range(max_lag)]
    )  # (max_lag, d)
    # a constant (stuck) chain has zero variance: define rho = 0 there so
    # ess degrades to c*t instead of NaN-poisoning the summary
    var0 = jnp.where(acovs[0] > 0, acovs[0], 1.0)
    rho = jnp.where(acovs[0] > 0, acovs / var0, jnp.zeros_like(acovs))
    # truncate at first negative autocorrelation
    positive = jnp.cumprod(rho > 0, axis=0).astype(samples.dtype)
    tau = 1.0 + 2.0 * jnp.sum(rho[1:] * positive[1:], axis=0)
    return c * t / jnp.maximum(tau, 1.0)


def posterior_summary(samples: jax.Array):
    """(mean, std, rhat, ess) over chains x draws, in NATURAL space
    theta = exp(z)."""
    theta = jnp.exp(samples)
    flat = theta.reshape(-1, theta.shape[-1])
    return {
        "mean": jnp.mean(flat, axis=0),
        "std": jnp.std(flat, axis=0),
        "rhat": split_rhat(samples),
        "ess": effective_sample_size(samples),
    }


# ---------------------------------------------------------------------------
# chain checkpoint / resume (SURVEY.md §5.3: "checkpointed HMC chains give
# natural resume" — the failure-recovery story of the sampler)
# ---------------------------------------------------------------------------

def save_chain_checkpoint(path: str, result: HMCResult, states: ChainState | None = None) -> None:
    """Persist adapted kernel + draws (+ final chain states) as one npz."""
    import numpy as np

    payload = {
        "samples": np.asarray(result.samples),
        "accept_rate": np.asarray(result.accept_rate),
        "step_size": np.asarray(result.step_size),
        "inv_mass": np.asarray(result.inv_mass),
    }
    if states is not None:
        payload["state_z"] = np.asarray(states.z)
        payload["state_logp"] = np.asarray(states.logp)
        payload["state_grad"] = np.asarray(states.grad)
    np.savez(path, **payload)


def load_chain_checkpoint(path: str):
    """(HMCResult, ChainState | None) from :func:`save_chain_checkpoint`."""
    import numpy as np

    z = np.load(path)
    result = HMCResult(
        samples=jnp.asarray(z["samples"]),
        accept_rate=jnp.asarray(z["accept_rate"]),
        step_size=jnp.asarray(z["step_size"]),
        inv_mass=jnp.asarray(z["inv_mass"]),
    )
    states = None
    if "state_z" in z:
        states = ChainState(
            z=jnp.asarray(z["state_z"]),
            logp=jnp.asarray(z["state_logp"]),
            grad=jnp.asarray(z["state_grad"]),
        )
    return result, states


def resume_hmc(
    logp_fn: Callable,
    checkpoint_path: str,
    key,
    num_samples: int,
    cfg: HMCConfig = HMCConfig(),
) -> HMCResult:
    """Continue sampling from a checkpoint WITHOUT re-warming: reuses the
    adapted step size and mass matrix, restarts chains from their last
    positions (or the last stored draw)."""
    prev, states = load_chain_checkpoint(checkpoint_path)
    if states is None:
        last = prev.samples[:, -1, :]
        states = init_chains(logp_fn, last)
    n_chains = states.z.shape[0]
    logp_grad_fn = jax.value_and_grad(logp_fn)
    eps = prev.step_size
    inv_mass = prev.inv_mass

    def sample_step(states, key_t):
        keys = jax.random.split(key_t, n_chains)
        new_states, accept_probs = jax.vmap(
            lambda s, k: _hmc_transition(logp_grad_fn, s, k, eps, inv_mass, cfg)
        )(states, keys)
        return new_states, (new_states.z, accept_probs)

    keys = jax.random.split(key, num_samples)
    states, (zs, accepts) = lax.scan(sample_step, states, keys)
    return HMCResult(
        samples=jnp.swapaxes(zs, 0, 1),
        accept_rate=jnp.mean(accepts, axis=0),
        step_size=eps,
        inv_mass=inv_mass,
    )
