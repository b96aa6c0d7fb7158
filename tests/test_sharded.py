"""Multi-device distributed linalg tests (8 virtual CPU devices).

The reference has nothing distributed to test (SURVEY.md §4 "what does NOT
exist"); these tests cover the scale-out the rebuild adds:
row-sharded Gram, block-panel distributed Cholesky with collectives,
owner-compute/psum-broadcast triangular solves, and the sharded GP fit
against its single-device reference."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpr_tpu.kernels.kernels import Gaussian, gram
from gpr_tpu.parallel import sharded_gram as sg


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return sg.default_mesh(8)


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


class TestShardedGram:
    def test_matches_single_device(self, mesh):
        rng = np.random.default_rng(0)
        X = jnp.asarray(rng.standard_normal((64, 3)))
        k = Gaussian(1.5, 1.0)
        K = np.asarray(sg.sharded_gram(k, X, mesh))
        np.testing.assert_allclose(K, np.asarray(gram(k, X)), atol=1e-12)

    def test_indivisible_raises(self, mesh):
        with pytest.raises(ValueError):
            sg.sharded_gram(Gaussian(1.0, 1.0), jnp.zeros((30, 2)), mesh)


class TestShardedCholesky:
    @pytest.mark.parametrize("n", [32, 128])
    @pytest.mark.slow
    def test_matches_numpy(self, mesh, n):
        A = _spd(n)
        L = np.tril(np.asarray(sg.cholesky_sharded(jnp.asarray(A), mesh)))
        np.testing.assert_allclose(L, np.linalg.cholesky(A), atol=1e-9 * n)

    @pytest.mark.slow
    def test_solve(self, mesh):
        n = 64
        A = _spd(n, seed=1)
        L = np.tril(np.asarray(sg.cholesky_sharded(jnp.asarray(A), mesh)))
        B = np.random.default_rng(2).standard_normal((n, 3))
        X = np.asarray(sg.cho_solve_sharded(jnp.asarray(L), jnp.asarray(B), mesh))
        np.testing.assert_allclose(A @ X, B, atol=1e-8)

    def test_panel_solve_not_replicated(self):
        """Round-4 owner-rows contract (VERDICT r3 #6): inside the SPMD
        body, every triangular solve operates on the device's OWN
        (nb, nb) row block — the round-3 schedule solved the FULL
        (n - k·nb, nb) below-panel on every device (O(n·nb²) replicated
        work).  Assert structurally on the jaxpr: no triangular_solve
        primitive sees an operand taller than nb."""
        import jax

        D, nb = 8, 16
        n = D * nb
        mesh = sg.default_mesh(D)
        jaxpr = jax.make_jaxpr(
            lambda K: sg.cholesky_sharded(K, mesh)
        )(jnp.zeros((n, n)))

        # collect over all nested jaxprs (cholesky_blocked etc. inline)
        sizes = []
        stack = [jaxpr.jaxpr]
        while stack:
            j = stack.pop()
            for eqn in j.eqns:
                if "triangular_solve" in eqn.primitive.name:
                    sizes.append(
                        max(v.aval.shape[0] for v in eqn.invars
                            if hasattr(v.aval, "shape") and v.aval.shape)
                    )
                for p in eqn.params.values():
                    cands = p if isinstance(p, (list, tuple)) else (p,)
                    for q in cands:
                        if hasattr(q, "eqns"):       # raw Jaxpr
                            stack.append(q)
                        elif hasattr(q, "jaxpr"):    # ClosedJaxpr
                            stack.append(q.jaxpr)
        assert sizes, "expected triangular solves in the panel body"
        assert max(sizes) <= nb, (
            f"panel solve sees a {max(sizes)}-row operand (> nb={nb}): "
            "the below-panel solve is replicated again"
        )


class TestShardedFit:
    @pytest.mark.slow
    def test_matches_exact_fit(self, mesh):
        """Sharded training must reproduce the single-device alpha and
        logdet (the north-star 'bit-matched posterior moments' requirement
        applied to the distributed path)."""
        rng = np.random.default_rng(3)
        n = 96
        X = jnp.asarray(rng.standard_normal((n, 2)))
        Y = jnp.asarray(rng.standard_normal((n, 2)))
        k = Gaussian(1.2, 0.9)
        alpha, logdet, L = sg.fit_sharded(k, X, Y, 0.3, mesh)

        from gpr_tpu.gp import exact
        from gpr_tpu.ops import linalg

        gp = exact.fit(k, X, Y, sigma=0.3)
        np.testing.assert_allclose(
            np.asarray(alpha), np.asarray(gp.alpha), atol=1e-9
        )
        np.testing.assert_allclose(
            float(logdet), float(linalg.logdet_from_chol(gp.L)), rtol=1e-12
        )


class TestShardedNUTS:
    @pytest.mark.slow
    def test_nuts_chains_over_mesh(self):
        """NUTS through the sharded driver: psum'd adaptation, correct
        moments."""
        from gpr_tpu.parallel.sharded_hmc import (
            default_mesh as chains_mesh,
            sample_hmc_sharded,
        )
        from gpr_tpu.inference.nuts import NUTSConfig, sample_nuts

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        logp = lambda z: -0.5 * jnp.sum(z * z)
        res = sample_hmc_sharded(
            logp, np.zeros((16, 2)), jax.random.PRNGKey(0),
            cfg=NUTSConfig(num_warmup=100, num_samples=100, max_depth=5),
            mesh=chains_mesh(8), sampler=sample_nuts,
        )
        s = np.asarray(res.samples).reshape(-1, 2)
        np.testing.assert_allclose(s.mean(0), [0, 0], atol=0.2)
        np.testing.assert_allclose(s.std(0), [1, 1], atol=0.25)


class TestShardedChunked:
    """Chunked sampling composed with sharded chains (VERDICT r1 weak #4):
    the python chunk loop stays at host level; each jitted chunk program is
    shard_mapped over the mesh."""

    @pytest.mark.slow
    def test_matches_single_device_chunked(self):
        """Sharded-chunked draws must BITWISE match the single-device
        chunked sampler: per-chain keys are sliced from the same global key
        set, warmup draws return as global arrays (host-level mass
        estimation over all chains), and the acceptance statistic is the
        flat mean over the all-gathered global accept vector."""
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from gpr_tpu.inference.hmc import HMCConfig, sample_hmc_chunked
        from gpr_tpu.parallel.sharded_hmc import (
            default_mesh as chains_mesh,
            sample_hmc_sharded_chunked,
        )

        logp = lambda z: -0.5 * jnp.sum(z * z)
        cfg = HMCConfig(num_warmup=60, num_samples=40, num_leapfrog=8)
        z0 = jax.random.normal(jax.random.PRNGKey(0), (8, 2))
        key = jax.random.PRNGKey(1)

        ref = sample_hmc_chunked(logp, z0, key, cfg, chunk_size=16)
        for n_dev in (4, 8):
            res = sample_hmc_sharded_chunked(
                logp, z0, key, cfg, chunk_size=16, mesh=chains_mesh(n_dev)
            )
            np.testing.assert_array_equal(
                np.asarray(res.samples), np.asarray(ref.samples)
            )
            assert float(res.step_size) == float(ref.step_size)
            np.testing.assert_array_equal(
                np.asarray(res.inv_mass), np.asarray(ref.inv_mass)
            )

    @pytest.mark.slow
    def test_windowed_warmup_and_remainder_chunks(self):
        """Windowed warmup (Stan-style expanding windows) and a chunk size
        that doesn't divide the stage lengths exercise the remainder chunk
        programs under shard_map."""
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from gpr_tpu.inference.hmc import HMCConfig, sample_hmc_chunked
        from gpr_tpu.parallel.sharded_hmc import (
            default_mesh as chains_mesh,
            sample_hmc_sharded_chunked,
        )

        logp = lambda z: -0.5 * jnp.sum(z * z)
        cfg = HMCConfig(
            num_warmup=45, num_samples=23, num_leapfrog=4,
            windowed_warmup=True,
        )
        z0 = jax.random.normal(jax.random.PRNGKey(3), (16, 3))
        key = jax.random.PRNGKey(4)
        ref = sample_hmc_chunked(logp, z0, key, cfg, chunk_size=10)
        res = sample_hmc_sharded_chunked(
            logp, z0, key, cfg, chunk_size=10, mesh=chains_mesh(8)
        )
        np.testing.assert_array_equal(
            np.asarray(res.samples), np.asarray(ref.samples)
        )
        assert float(res.step_size) == float(ref.step_size)

    @pytest.mark.slow
    def test_nuts_matches_single_device_chunked(self):
        """Sharded-chunked NUTS (the NUTS counterpart of the production
        multi-chip path) must bitwise-match the single-device chunked
        sampler under the same key flow."""
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from gpr_tpu.inference.nuts import NUTSConfig, sample_nuts_chunked
        from gpr_tpu.parallel.sharded_hmc import (
            default_mesh as chains_mesh,
            sample_nuts_sharded_chunked,
        )

        logp = lambda z: -0.5 * jnp.sum(z * z)
        cfg = NUTSConfig(num_warmup=30, num_samples=17, max_depth=4)
        z0 = jax.random.normal(jax.random.PRNGKey(7), (8, 2))
        key = jax.random.PRNGKey(8)
        ref = sample_nuts_chunked(logp, z0, key, cfg, chunk_size=7)
        res = sample_nuts_sharded_chunked(
            logp, z0, key, cfg, chunk_size=7, mesh=chains_mesh(4)
        )
        np.testing.assert_array_equal(
            np.asarray(res.samples), np.asarray(ref.samples)
        )
        assert float(res.step_size) == float(ref.step_size)
        np.testing.assert_array_equal(
            np.asarray(res.inv_mass), np.asarray(ref.inv_mass)
        )


class TestDeterminism:
    def test_sharded_hmc_reproducible(self):
        """Fixed PRNG keys -> bitwise-identical sharded chains across runs
        (SURVEY.md §7 'multi-host determinism' hard part)."""
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from gpr_tpu.parallel.sharded_hmc import (
            default_mesh as chains_mesh,
            sample_hmc_sharded,
        )
        from gpr_tpu.inference.hmc import HMCConfig

        logp = lambda z: -0.5 * jnp.sum(z * z)
        cfg = HMCConfig(num_warmup=50, num_samples=50)
        r1 = sample_hmc_sharded(
            logp, np.zeros((16, 2)), jax.random.PRNGKey(5), cfg,
            mesh=chains_mesh(8),
        )
        r2 = sample_hmc_sharded(
            logp, np.zeros((16, 2)), jax.random.PRNGKey(5), cfg,
            mesh=chains_mesh(8),
        )
        np.testing.assert_array_equal(
            np.asarray(r1.samples), np.asarray(r2.samples)
        )
        assert float(r1.step_size) == float(r2.step_size)

    @pytest.mark.slow
    def test_sharded_fit_deterministic(self):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        rng = np.random.default_rng(9)
        X = jnp.asarray(rng.standard_normal((64, 2)))
        Y = jnp.asarray(rng.standard_normal((64, 1)))
        k = Gaussian(1.1, 0.8)
        mesh = sg.default_mesh(8)
        a1, l1, _ = sg.fit_sharded(k, X, Y, 0.2, mesh)
        a2, l2, _ = sg.fit_sharded(k, X, Y, 0.2, mesh)
        np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
        assert float(l1) == float(l2)


class TestShardedWindowedNUTS:
    def test_combo(self):
        """Sharded NUTS with windowed warmup: psum'd per-window mass
        estimation across devices."""
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from gpr_tpu.parallel.sharded_hmc import (
            default_mesh as chains_mesh,
            sample_hmc_sharded,
        )
        from gpr_tpu.inference.nuts import NUTSConfig, sample_nuts

        scales = jnp.asarray([0.1, 5.0])
        logp = lambda z: -0.5 * jnp.sum((z / scales) ** 2)
        res = sample_hmc_sharded(
            logp, np.zeros((16, 2)), jax.random.PRNGKey(1),
            cfg=NUTSConfig(num_warmup=150, num_samples=100, max_depth=6,
                           windowed_warmup=True),
            mesh=chains_mesh(8), sampler=sample_nuts,
        )
        s = np.asarray(res.samples).reshape(-1, 2)
        np.testing.assert_allclose(s.std(0), np.asarray(scales), rtol=0.35)
        im = np.asarray(res.inv_mass)
        assert im[1] / im[0] > 100


@pytest.mark.slow
def test_safe_cholesky_sharded_escalates():
    """A singular sharded K recovers via jitter escalation (parity with
    the single-device safe_cholesky); a healthy K uses zero jitter."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from gpr_tpu.parallel import sharded_gram as sg

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = sg.default_mesh(8)
    rng = np.random.default_rng(3)
    G = rng.standard_normal((64, 64))
    A = jnp.asarray(G @ G.T + 64 * np.eye(64))
    L, j = sg.safe_cholesky_sharded(A, mesh)
    assert float(j) == 0.0
    ref = np.linalg.cholesky(np.asarray(A))
    np.testing.assert_allclose(np.asarray(L), ref, atol=1e-8)
    bad = jnp.zeros((64, 64))
    Lb, jb = sg.safe_cholesky_sharded(bad, mesh)
    assert float(jb) > 0.0
    assert bool(jnp.all(jnp.isfinite(Lb)))
