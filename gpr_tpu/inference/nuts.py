"""No-U-Turn Sampler (iterative, accelerator-friendly).

The adaptive-trajectory companion to ``inference.hmc`` — the north-star
sampler named in BASELINE.json ("NUTS/HMC ... leapfrog log-prob gradients
as one jitted function").  The reference has no sampler at all (its
``GaussianProcessInference`` is a pinv Gauss-Newton point estimator,
reference include/GaussianProcessInference.h:84-229).

Design: the classic recursive tree build is re-expressed ITERATIVELY with a
checkpoint stack of size ``max_depth`` so the whole transition is one
``jit``-compilable program of static shape:

  * outer (static) loop over tree depth doublings;
  * inner ``lax.fori_loop`` over the 2^d leapfrog steps of each subtree;
  * balanced-subtree U-turn checks via the trailing-zeros trick — leaf m
    stores its (z, p) in stack level j whenever 2^j | m, and after leaf i
    every level with 2^j | (i+1) compares against its stored start;
  * progressive multinomial sampling inside the subtree, biased
    trajectory sampling across doublings (Stan-style);
  * divergence guard at dH < -1000.

Chains vmap cleanly; the sharded-chain driver (parallel.sharded_hmc) can
wrap :func:`sample_nuts` exactly like plain HMC.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .hmc import ChainState, _adapt_phase, init_chains


@dataclasses.dataclass(frozen=True)
class NUTSConfig:
    num_warmup: int = 500
    num_samples: int = 500
    max_depth: int = 8
    target_accept: float = 0.8
    initial_step_size: float = 0.1
    max_step_size: float = 10.0
    divergence_threshold: float = 1000.0
    windowed_warmup: bool = False  # Stan-style expanding windows (see hmc)


class _TrajState(NamedTuple):
    # endpoints (chronological minus/plus)
    zm: jax.Array
    pm: jax.Array
    gm: jax.Array
    lpm: jax.Array
    zp: jax.Array
    pp: jax.Array
    gp: jax.Array
    lpp: jax.Array
    # current proposal
    z_prop: jax.Array
    lp_prop: jax.Array
    g_prop: jax.Array
    # bookkeeping
    log_sum_w: jax.Array
    turning: jax.Array
    diverged: jax.Array
    sum_accept: jax.Array  # accumulated acceptance statistic
    n_leaves: jax.Array


def _kinetic(p, inv_mass):
    return 0.5 * jnp.sum(inv_mass * p * p)


def _leapfrog_step(logp_grad_fn, z, p, g, eps, inv_mass):
    p = p + 0.5 * eps * g
    z = z + eps * inv_mass * p
    lp, g = logp_grad_fn(z)
    p = p + 0.5 * eps * g
    return z, p, g, lp


def _build_subtree(
    logp_grad_fn, z0, p0, g0, direction, depth, eps, inv_mass, H0, key, cfg
):
    """Integrate 2^depth steps from (z0, p0); returns subtree summary."""
    dim = z0.shape[0]
    n_steps = 2**depth
    levels = depth + 1

    stack_z = jnp.zeros((levels, dim), z0.dtype)
    stack_p = jnp.zeros((levels, dim), z0.dtype)

    def body(i, carry):
        (z, p, g, lp, sz, sp, lsw, prop, turning, diverged, acc, nl, key) = carry
        z, p, g, lp = _leapfrog_step(
            logp_grad_fn, z, p, g, direction * eps, inv_mass
        )
        dH = (lp - _kinetic(p, inv_mass)) - H0
        dH = jnp.where(jnp.isnan(dH), -jnp.inf, dH)
        div_now = dH < -cfg.divergence_threshold
        # the Metropolis statistic counts only leaves of the live
        # trajectory: once the subtree turned or diverged, later leaves
        # exist only because the loop is static — Stan's recursion would
        # never compute them, and letting them dilute the dual-averaging
        # statistic biases the adapted step size exactly when trajectories
        # terminate early
        live = jnp.logical_not(jnp.logical_or(turning, diverged))
        acc = acc + jnp.where(live, jnp.minimum(1.0, jnp.exp(dH)), 0.0)
        nl = nl + jnp.where(live, 1.0, 0.0)

        # store leaf i into every stack level j with 2^j | i
        j_idx = jnp.arange(levels)
        store = (jnp.mod(i, 2**j_idx) == 0)[:, None]
        sz = jnp.where(store, z[None, :], sz)
        sp = jnp.where(store, p[None, :], sp)

        # completed balanced subtrees: levels j >= 1 with 2^j | (i+1)
        complete = jnp.logical_and(jnp.mod(i + 1, 2**j_idx) == 0, j_idx >= 1)
        dz = direction * (z[None, :] - sz)  # chronological delta per level
        turn_j = jnp.logical_or(
            jnp.sum(dz * (inv_mass[None, :] * sp), axis=1) < 0,
            jnp.sum(dz * (inv_mass[None, :] * p[None, :]), axis=1) < 0,
        )
        turning_now = jnp.any(jnp.logical_and(complete, turn_j))

        # progressive multinomial sampling within the subtree
        key, k_acc = jax.random.split(key)
        lsw_new = jnp.logaddexp(lsw, dH)
        take = jax.random.uniform(k_acc, ()) < jnp.exp(dH - lsw_new)
        prop_z, prop_lp, prop_g = prop
        prop = (
            jnp.where(take, z, prop_z),
            jnp.where(take, lp, prop_lp),
            jnp.where(take, g, prop_g),
        )

        # freeze all accumulators once the subtree is invalid (live is the
        # validity at entry to this step, computed above)
        lsw = jnp.where(live, lsw_new, lsw)
        turning = jnp.logical_or(turning, jnp.logical_and(live, turning_now))
        diverged = jnp.logical_or(diverged, jnp.logical_and(live, div_now))
        return (z, p, g, lp, sz, sp, lsw, prop, turning, diverged, acc, nl, key)

    init = (
        z0,
        p0,
        g0,
        jnp.asarray(0.0, z0.dtype),
        stack_z,
        stack_p,
        jnp.asarray(-jnp.inf, z0.dtype),
        (z0, jnp.asarray(-jnp.inf, z0.dtype), g0),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.asarray(0.0, z0.dtype),
        jnp.asarray(0.0, z0.dtype),
        key,
    )
    (z, p, g, lp, _, _, lsw, prop, turning, diverged, acc, nl, _) = lax.fori_loop(
        0, n_steps, body, init
    )
    return z, p, g, lp, lsw, prop, turning, diverged, acc, nl


def _nuts_transition(logp_grad_fn, state: ChainState, key, eps, inv_mass, cfg):
    """One NUTS update.  Returns (new_state, accept_stat)."""
    k_mom, k_loop = jax.random.split(key)
    dim = state.z.shape[0]
    p0 = jax.random.normal(k_mom, (dim,), state.z.dtype) / jnp.sqrt(inv_mass)
    H0 = state.logp - _kinetic(p0, inv_mass)

    traj = _TrajState(
        zm=state.z, pm=p0, gm=state.grad, lpm=state.logp,
        zp=state.z, pp=p0, gp=state.grad, lpp=state.logp,
        z_prop=state.z, lp_prop=state.logp, g_prop=state.grad,
        log_sum_w=jnp.asarray(0.0, state.z.dtype),
        turning=jnp.asarray(False),
        diverged=jnp.asarray(False),
        sum_accept=jnp.asarray(0.0, state.z.dtype),
        n_leaves=jnp.asarray(0.0, state.z.dtype),
    )

    keys = jax.random.split(k_loop, cfg.max_depth)
    for depth in range(cfg.max_depth):
        k_dir, k_sub, k_swap = jax.random.split(keys[depth], 3)
        going = jnp.logical_not(jnp.logical_or(traj.turning, traj.diverged))
        direction = jnp.where(
            jax.random.bernoulli(k_dir), 1.0, -1.0
        ).astype(state.z.dtype)
        z0 = jnp.where(direction > 0, traj.zp, traj.zm)
        p0_end = jnp.where(direction > 0, traj.pp, traj.pm)
        g0 = jnp.where(direction > 0, traj.gp, traj.gm)

        (z_e, p_e, g_e, lp_e, lsw_sub, prop, turn_sub, div_sub, acc, n_sub) = (
            _build_subtree(
                logp_grad_fn, z0, p0_end, g0, direction, depth, eps,
                inv_mass, H0, k_sub, cfg,
            )
        )

        # biased trajectory sampling: accept the subtree proposal with
        # prob min(1, w_sub / w_old) when the subtree itself is valid
        sub_ok = jnp.logical_not(jnp.logical_or(turn_sub, div_sub))
        swap = jnp.logical_and(
            jnp.logical_and(going, sub_ok),
            jax.random.uniform(k_swap, ())
            < jnp.exp(lsw_sub - traj.log_sum_w),
        )
        z_prop = jnp.where(swap, prop[0], traj.z_prop)
        lp_prop = jnp.where(swap, prop[1], traj.lp_prop)
        g_prop = jnp.where(swap, prop[2], traj.g_prop)

        # extend the moved endpoint
        upd = jnp.logical_and(going, sub_ok)
        fwd = jnp.logical_and(upd, direction > 0)
        bwd = jnp.logical_and(upd, direction < 0)
        zp = jnp.where(fwd, z_e, traj.zp)
        pp = jnp.where(fwd, p_e, traj.pp)
        gp = jnp.where(fwd, g_e, traj.gp)
        lpp = jnp.where(fwd, lp_e, traj.lpp)
        zm = jnp.where(bwd, z_e, traj.zm)
        pm = jnp.where(bwd, p_e, traj.pm)
        gm = jnp.where(bwd, g_e, traj.gm)
        lpm = jnp.where(bwd, lp_e, traj.lpm)

        # overall U-turn across the full trajectory
        dz = zp - zm
        turn_all = jnp.logical_or(
            jnp.sum(dz * (inv_mass * pm)) < 0,
            jnp.sum(dz * (inv_mass * pp)) < 0,
        )

        traj = _TrajState(
            zm=zm, pm=pm, gm=gm, lpm=lpm,
            zp=zp, pp=pp, gp=gp, lpp=lpp,
            z_prop=z_prop, lp_prop=lp_prop, g_prop=g_prop,
            log_sum_w=jnp.where(
                upd, jnp.logaddexp(traj.log_sum_w, lsw_sub), traj.log_sum_w
            ),
            turning=jnp.logical_or(
                traj.turning,
                jnp.logical_and(going, jnp.logical_or(turn_sub, turn_all)),
            ),
            diverged=jnp.logical_or(
                traj.diverged, jnp.logical_and(going, div_sub)
            ),
            sum_accept=traj.sum_accept + jnp.where(going, acc, 0.0),
            n_leaves=traj.n_leaves + jnp.where(going, n_sub, 0.0),
        )

    new_state = ChainState(z=traj.z_prop, logp=traj.lp_prop, grad=traj.g_prop)
    accept_stat = traj.sum_accept / jnp.maximum(traj.n_leaves, 1.0)
    return new_state, accept_stat


class NUTSResult(NamedTuple):
    samples: jax.Array  # (chains, T, dim) log space
    accept_rate: jax.Array
    step_size: jax.Array
    inv_mass: jax.Array


def sample_nuts(
    logp_fn: Callable,
    z0,
    key,
    cfg: NUTSConfig = NUTSConfig(),
    cross_chain_mean: Optional[Callable] = None,
    cross_chain_moments: Optional[Callable] = None,
) -> NUTSResult:
    """Vmapped NUTS chains with the same three-stage warmup as
    :func:`hmc.sample_hmc` (dual-averaged step size, psum-able adaptation
    hooks for the sharded driver)."""
    z0 = jnp.atleast_2d(jnp.asarray(z0))
    n_chains, dim = z0.shape
    logp_grad_fn = jax.value_and_grad(logp_fn)
    states = init_chains(logp_fn, z0)
    k1, k2, k3 = jax.random.split(key, 3)

    def transition(s, k, e, im):
        return _nuts_transition(logp_grad_fn, s, k, e, im, cfg)

    # warmup (dual-averaged step size, mass windows) is the SINGLE shared
    # implementation in inference.hmc, parameterized by the transition
    states, eps2, inv_mass = _adapt_phase(
        logp_grad_fn, states, k1, k2, cfg, dim, z0.dtype,
        cross_chain_mean, cross_chain_moments, transition=transition,
    )

    def sample_step(states, key_t):
        keys = jax.random.split(key_t, n_chains)
        new_states, accept = jax.vmap(
            lambda s, k: transition(s, k, eps2, inv_mass)
        )(states, keys)
        return new_states, (new_states.z, accept)

    keys = jax.random.split(k3, cfg.num_samples)
    states, (zs, accepts) = lax.scan(sample_step, states, keys)
    return NUTSResult(
        samples=jnp.swapaxes(zs, 0, 1),
        accept_rate=jnp.mean(accepts, axis=0),
        step_size=eps2,
        inv_mass=inv_mass,
    )


def sample_nuts_chunked(
    logp_fn: Callable,
    z0,
    key,
    cfg: NUTSConfig = NUTSConfig(),
    chunk_size: int = 16,
    cross_chain_mean: Optional[Callable] = None,
    cross_chain_moments: Optional[Callable] = None,
    shard_ctx=None,
) -> NUTSResult:
    """``sample_nuts`` with warmup and sampling python-unrolled in jitted
    chunks, so no compiled program holds a scan over a NUTS transition
    (see ``hmc.sample_hmc_chunked`` for the contract).  Same key flow
    as ``sample_nuts``; adapted step size / mass are traced arguments so
    repeat calls reuse the cached chunk programs.

    With ``shard_ctx`` (an ``hmc.ShardCtx``) each chunk program is
    ``shard_map``-ped with the chain axis device-sharded, exactly like
    ``hmc.sample_hmc_chunked`` — see
    :func:`gpr_tpu.parallel.sample_nuts_sharded_chunked`."""
    from .hmc import _adapt_phase, _cached_program, _split_chain_keys, init_chains

    z0 = jnp.atleast_2d(jnp.asarray(z0))
    n_chains, dim = z0.shape
    logp_grad_fn = jax.value_and_grad(logp_fn)
    # clamp BEFORE warmup (see sample_hmc_chunked)
    chunk_size = max(1, min(chunk_size, cfg.num_samples))
    states = init_chains(logp_fn, z0)
    k1, k2, k3 = jax.random.split(key, 3)

    def transition(s, k, e, im):
        return _nuts_transition(logp_grad_fn, s, k, e, im, cfg)

    states, eps2, inv_mass = _adapt_phase(
        logp_grad_fn, states, k1, k2, cfg, dim, z0.dtype,
        cross_chain_mean, cross_chain_moments, transition=transition,
        unroll_chunk=chunk_size, cache_anchor=logp_fn,
        transition_key=("nuts", cfg), shard_ctx=shard_ctx,
    )

    def make_chunk_fn(length: int):
        def build():
            def run(states, keys_chunk, eps, inv_mass):
                zs, accs = [], []
                for t in range(length):
                    keys = _split_chain_keys(
                        keys_chunk[t], states.z.shape[0], shard_ctx
                    )
                    states, a = jax.vmap(
                        lambda s, k: transition(s, k, eps, inv_mass)
                    )(states, keys)
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
            logp_fn, ("nuts_sample", length, n_chains, cfg, shard_ctx), build
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

    zs = jnp.concatenate(zs_parts, axis=0)
    accepts = jnp.concatenate(acc_parts, axis=0)
    return NUTSResult(
        samples=jnp.swapaxes(zs, 0, 1),
        accept_rate=jnp.mean(accepts, axis=0),
        step_size=eps2,
        inv_mass=inv_mass,
    )
