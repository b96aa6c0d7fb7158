#!/usr/bin/env python3
"""Smoke run of the exact-GP engine's main paths on one NVIDIA GPU.

Each phase drives the public entry points at the sizes users run and
compares the result with a plain float64 reference:

  device   the first JAX device must be a GPU (no CPU fallback);
  fit      ``gpr_tpu.fit`` at n=16384, d=128, q=8 in float32 against a
           float64 Gram (direct differences) -> Cholesky -> cho_solve on the
           card, plus a singular (duplicated-rows, sigma=0) case at n=3773
           that must escalate the jitter;
  study    the reference's learn -> predict -> serve study at breathing-trace
           scale (3773 + 256 frames of 64x64 ultrasound, 16x16x16x3 DVFs)
           through ``apps.learn``, ``apps.predict`` and ``apps.serve.Server``
           (float64, as the CLIs run), against a host float64 recomputation
           from the saved model;
  fleet    ``fit_batched`` at B=128, n=512 against per-member float64 solves;
  sampler  ``mll_scalar`` value and gradient at n=256 against float64, then
           a few chunked HMC and NUTS transitions.

With ``--multi`` only the sharded paths run, over four cards:
``parallel.fit_sharded`` at n=32768 against a one-card float64 solve,
``sample_hmc_sharded_chunked`` against the one-device chunked sampler, and
``fit_batched_sharded`` against ``fit_batched``.

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # four cards

Everything runs in this one process.  Each phase prints its errors beside
their tolerances and its seconds; the card's name and power limit come from
``nvidia-smi``.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
printed only when every phase passed; otherwise the exit code is 1.  Every
phase is a function with its sizes as arguments, so the test suite runs
them at tiny sizes on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

import gpr_tpu
from gpr_tpu.utils.compile_cache import setup_compile_cache

F32 = np.float32

# tolerances: max-abs error over max-abs reference value
TOL_FIT = 5e-3  # alpha and L of the float32 fit
TOL_STUDY = 1e-4  # predicted features and credible interval
TOL_FLEET = 5e-3  # fleet alpha
TOL_MLL = 1e-4  # mll value
TOL_MLL_GRAD = 1e-3  # mll gradient
TOL_LOGDET = 1e-4  # sharded fit log-determinant
TOL_SAMPLER_PARITY = 1e-4  # sharded vs one-device chunked HMC draws


class SmokeFailure(AssertionError):
    """A measured error above its tolerance, or a wrong dtype or shape."""


def _check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _say(phase: str, **kv) -> None:
    body = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {body}", flush=True)


def _rel(a, ref) -> float:
    """max |a - ref| / max |ref|, in float64 on the host."""
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref)) / np.max(np.abs(ref)))


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# float64 references (plain jax.numpy, no gpr_tpu code)
# ---------------------------------------------------------------------------

def _sqdist_direct(A, B):
    """sum_k (a_ik - b_jk)^2 by direct differences, one feature at a time
    (bounded memory at n=32768 and no |a|^2 + |b|^2 - 2ab cancellation)."""
    import jax
    import jax.numpy as jnp

    def body(k, D):
        a = jax.lax.dynamic_slice_in_dim(A, k, 1, axis=1)
        b = jax.lax.dynamic_slice_in_dim(B, k, 1, axis=1)
        return D + (a - b.T) ** 2

    D0 = jnp.zeros((A.shape[0], B.shape[0]), A.dtype)
    return jax.lax.fori_loop(0, A.shape[1], body, D0)


def _reference_fit(X, Y, ell, scale, noise):
    """Gaussian-kernel GP fit in the dtype of X: (L, alpha)."""
    import jax
    import jax.numpy as jnp

    K = scale**2 * jnp.exp(-0.5 * _sqdist_direct(X, X) / ell**2)
    K = K + noise**2 * jnp.eye(X.shape[0], dtype=X.dtype)
    L = jnp.linalg.cholesky(K)
    return L, jax.scipy.linalg.cho_solve((L, True), Y)


def _np_gaussian(A, B, ell, scale):
    d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
    return scale**2 * np.exp(-0.5 * d2 / ell**2)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(platform: str = "gpu"):
    """The first JAX device, which must be on ``platform``."""
    import jax

    dev = jax.devices()[0]
    _check(
        dev.platform == platform,
        f"no {platform}: JAX's first device is {dev.platform} "
        f"({dev.device_kind}); refusing to fall back",
    )
    _say("device", platform=dev.platform, kind=repr(dev.device_kind),
         count=len(jax.devices()))
    return dev


def phase_fit(n: int = 16384, d: int = 128, q: int = 8, seed: int = 0,
              ell: float = 8.0, noise: float = 0.1) -> dict:
    """``gpr_tpu.fit(Gaussian(ell, 1), X, Y, sigma=noise)`` in float32."""
    import jax
    import jax.numpy as jnp
    from gpr_tpu.kernels import kernels as kermod
    from gpr_tpu.ops import linalg

    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    Y = jnp.asarray(rng.standard_normal((n, q)), jnp.float32)
    kernel = gpr_tpu.Gaussian(jnp.float32(ell), jnp.float32(1.0))
    sigma = jnp.float32(noise)

    t0 = time.perf_counter()
    fit = jax.jit(gpr_tpu.fit).lower(kernel, X, Y, sigma).compile()
    t_compile = time.perf_counter() - t0
    gp, t_first = _timed(fit, kernel, X, Y, sigma)
    gp, t_fit = _timed(fit, kernel, X, Y, sigma)
    mem = fit.memory_analysis()
    if mem is not None:
        _say("fit", memory_GiB=json.dumps({
            k: round(getattr(mem, k) / 2**30, 3)
            for k in ("argument_size_in_bytes", "output_size_in_bytes",
                      "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(mem, k)
        }))
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        _say("fit", peak_device_GiB=f"{stats['peak_bytes_in_use'] / 2**30:.3f}")

    K_dtype = jax.eval_shape(
        lambda X: linalg.add_diagonal(kermod.gram(kernel, X), sigma**2), X
    ).dtype
    for name, dt in (("K", K_dtype), ("L", gp.L.dtype), ("alpha", gp.alpha.dtype)):
        _check(dt == jnp.float32, f"{name} is {dt}, not float32")
    _check(gp.alpha.shape == (n, q) and gp.L.shape == (n, n),
           f"shapes alpha {gp.alpha.shape} L {gp.L.shape}")

    jitter = float(jax.jit(
        lambda X: linalg.safe_cholesky(
            linalg.add_diagonal(kermod.gram(kernel, X), sigma**2))[1]
    )(X))
    _check(jitter == 0.0, f"safe_cholesky escalated: jitter={jitter}")

    with jax.enable_x64(True):
        X64 = X.astype(jnp.float64)
        ref = jax.jit(_reference_fit)
        L64, a64 = ref(X64, Y.astype(jnp.float64), 1.0 * ell, 1.0, 1.0 * noise)
        rel = jax.jit(
            lambda a, r: jnp.max(jnp.abs(a.astype(jnp.float64) - r))
            / jnp.max(jnp.abs(r))
        )
        e_alpha = float(rel(gp.alpha, a64))
        e_L = float(rel(gp.L, L64))
        del L64, a64
    _say("fit", n=n, d=d, q=q, dtypes="K,L,alpha=float32", jitter=jitter,
         alpha_err=f"{e_alpha:.3e}<={TOL_FIT}", L_err=f"{e_L:.3e}<={TOL_FIT}",
         compile_s=f"{t_compile:.3f}", first_s=f"{t_first:.4f}",
         fit_s=f"{t_fit:.5f}")
    _check(np.isfinite(e_alpha) and e_alpha <= TOL_FIT, f"alpha error {e_alpha}")
    _check(np.isfinite(e_L) and e_L <= TOL_FIT, f"L error {e_L}")
    return {"alpha_err": e_alpha, "L_err": e_L, "jitter": jitter,
            "fit_s": t_fit, "compile_s": t_compile}


def phase_escalation(n: int = 3773, d: int = 5, seed: int = 1) -> dict:
    """Duplicated rows and sigma=0: K is singular, so the factorization
    must escalate the jitter and still return a finite alpha."""
    import jax
    import jax.numpy as jnp
    from gpr_tpu.kernels import kernels as kermod
    from gpr_tpu.ops import linalg

    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n - n // 2, d))
    X = jnp.asarray(np.concatenate([base, base[: n // 2]]), jnp.float32)
    Y = jnp.asarray(rng.standard_normal((n, 2)), jnp.float32)
    kernel = gpr_tpu.Gaussian(jnp.float32(2.0), jnp.float32(1.0))

    gp = jax.jit(gpr_tpu.fit)(kernel, X, Y, jnp.float32(0.0))
    jitter = float(jax.jit(
        lambda X: linalg.safe_cholesky(kermod.gram(kernel, X))[1]
    )(X))
    finite = bool(jnp.all(jnp.isfinite(gp.alpha)))
    _say("fit", escalation_n=n, jitter=f"{jitter:.3e}>0", alpha_finite=finite)
    _check(jitter > 0.0, "singular K factored without jitter")
    _check(finite, "non-finite alpha after jitter escalation")
    return {"jitter": jitter}


def make_study_data(root: str, n_train: int, n_test: int,
                    us_shape=(64, 64), dvf_shape=(16, 16, 16), seed: int = 0):
    """Surrogate respiratory study: ultrasound frames whose speckled stripe
    pattern moves with a breathing signal, and 3-component displacement
    fields driven by the same signal (superior-inferior motion plus an
    anterior-posterior hysteresis term).  The period and amplitude drift
    like a free-breathing trace.  Writes ``{train,test}/{us,dvf}/*.vtk``."""
    from gpr_tpu.pipeline import imageio

    rng = np.random.default_rng(seed)
    T = n_train + n_test
    t = np.arange(T)
    period = 60.0 * (1.0 + 0.1 * np.sin(2 * np.pi * t / 900.0))
    phase = 2 * np.pi * np.cumsum(1.0 / period)
    amp = 1.0 + 0.2 * np.sin(2 * np.pi * t / 1300.0 + 1.0)
    si = amp * np.sin(phase) + 0.1 * np.sin(2 * np.pi * t / 2000.0)
    ap = 0.3 * amp * np.cos(phase)

    h, w = us_shape
    yy, xx = np.mgrid[0:h, 0:w]
    z, y, x = np.mgrid[0 : dvf_shape[0], 0 : dvf_shape[1], 0 : dvf_shape[2]]
    c = (np.asarray(dvf_shape) - 1) / 2.0
    prof = np.exp(-((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2)
                  / (2 * (dvf_shape[0] / 3.0) ** 2))
    dirs = {}
    for split, lo, hi in (("train", 0, n_train), ("test", n_train, T)):
        us_dir = os.path.join(root, split, "us")
        dvf_dir = os.path.join(root, split, "dvf")
        os.makedirs(us_dir)
        os.makedirs(dvf_dir)
        for i, k in enumerate(range(lo, hi)):
            img = (127.0 + 80.0 * np.sin(2 * np.pi * 4 * yy / h + 2.0 * si[k])
                   + 30.0 * np.cos(2 * np.pi * 3 * xx / w + ap[k])
                   + rng.normal(0.0, 8.0, us_shape))
            imageio.write_image(
                imageio.Image(np.clip(img, 0, 255), (1, 1), (0, 0)),
                os.path.join(us_dir, f"us{i:05d}.vtk"),
            )
            dvf = np.stack([5.0 * si[k] * prof, 2.0 * ap[k] * prof,
                            1.0 * si[k] ** 2 * prof], axis=-1)
            dvf = dvf + rng.normal(0.0, 0.05, dvf.shape)
            imageio.write_image(
                imageio.Image(dvf, (1, 1, 1), (0, 0, 0), ncomponents=3),
                os.path.join(dvf_dir, f"df{i:05d}.vtk"),
            )
        dirs[split] = (us_dir, dvf_dir)
    return dirs


# the study's model (examples/params/respiratory_synthetic.yaml gpr_model)
STUDY_MODEL = {
    "perform_ar": False,
    "n_inputModes": 5,
    "n_outputModes": 3,
    "ar_n": 1,
    "ar_p": 2,
    "kernel_string": "GaussianKernel(2, 1,)",
    "data_noise": 0.02,
}


def _host_model(prefix: str):
    """The saved model in float64 on the host: X, alpha, core, kernel."""
    from gpr_tpu.utils import matrixio

    def rd(s):
        return np.asarray(matrixio.read_matrix(prefix + s), np.float64)

    kernel = gpr_tpu.parse_kernel(
        open(prefix + "-ParameterFile.txt").readline().split(None, 5)[5].strip()
    )
    _check(isinstance(kernel, gpr_tpu.Gaussian), f"study kernel {kernel}")
    return (rd("-SampleVectors.txt").T, rd("-RegressionVectors.txt"),
            rd("-CoreMatrix.txt"), float(kernel.sigma), float(kernel.scale))


def _host_predict(model, Xs):
    X, alpha, core, ell, scale = model
    Ks = _np_gaussian(Xs, X, ell, scale)
    var = scale**2 - np.sum(Ks * (Ks @ core), axis=1)
    return Ks @ alpha, 2.0 * np.sqrt(np.maximum(var, 0.0))


def phase_study(n_train: int = 3773, n_test: int = 256, us_shape=(64, 64),
                dvf_shape=(16, 16, 16), n_serve: int = 16, seed: int = 0,
                workdir: str | None = None) -> dict:
    """learn -> predict -> serve through the app entry points.  The CLIs
    run in float64 as the reference does, and so does the Server here."""
    import jax
    from gpr_tpu.apps import learn, predict
    from gpr_tpu.apps.serve import Server
    from gpr_tpu.pipeline import imageio
    from gpr_tpu.pipeline.dataparser import read_csv

    with tempfile.TemporaryDirectory(dir=workdir) as root, jax.enable_x64(True):
        t0 = time.perf_counter()
        dirs = make_study_data(root, n_train, n_test, us_shape, dvf_shape, seed)
        t_data = time.perf_counter() - t0
        cm, cl, cp = (os.path.join(root, f) for f in ("cm.json", "cl.json", "cp.json"))
        json.dump(STUDY_MODEL, open(cm, "w"))
        json.dump({"use_precomputed": False, "n_trainImgs": 0,
                   "start_trainInd": 0}, open(cl, "w"))
        json.dump({"use_precomputed": False,
                   "compute_groundtruth_features": False}, open(cp, "w"))
        prefix = os.path.join(root, "gpr")
        results = os.path.join(root, "results")
        os.makedirs(results)
        (us_tr, dvf_tr), (us_te, dvf_te) = dirs["train"], dirs["test"]
        log = io.StringIO()

        def app(main, argv, name):
            t = time.perf_counter()
            with contextlib.redirect_stdout(log):
                rc = main(argv)
            dt = time.perf_counter() - t
            if rc != 0:
                print(log.getvalue()[-4000:])
            _check(rc == 0, f"{name} exited {rc}")
            return dt

        t_learn = app(learn.main, [cm, cl, prefix, us_tr, dvf_tr], "learn")
        ref_file = os.path.join(dvf_tr, sorted(os.listdir(dvf_tr))[0])
        t_predict = app(predict.main, [cm, cp, prefix, us_te, dvf_te, results,
                                       ref_file], "predict")
        _check(len(os.listdir(results)) == n_test, "predict wrote too few DVFs")

        model = _host_model(prefix)
        n_in = STUDY_MODEL["n_inputModes"]
        xs = read_csv(prefix + "-inputFeatures_prediction.csv")[:n_in].T
        feats = read_csv(prefix + "-outputFeatures_prediction.csv").T
        ci = np.asarray(
            open(prefix + "-credibleInterval.csv").read().strip(",").split(","),
            np.float64,
        )
        mean_ref, ci_ref = _host_predict(model, xs)
        e_feat = _rel(feats, mean_ref)
        e_ci = _rel(ci, ci_ref)
        lat = np.asarray(
            open(prefix + "-latestInferenceTime.txt").read().strip(",").split(","),
            np.float64,
        )

        server = Server(STUDY_MODEL, prefix, os.path.join(root, "served"))
        from gpr_tpu.pipeline import pca as pcamod

        in_pca = pcamod.load_pca(prefix + "-input")
        mean64 = np.asarray(in_pca.mean, np.float64)
        basis64 = np.asarray(in_pca.U, np.float64)[:, :n_in] / np.asarray(
            in_pca.sigma, np.float64)[:n_in]
        frames = sorted(os.listdir(us_te))[:n_serve]
        first = imageio.read_image(os.path.join(us_te, frames[0])).data
        t = time.perf_counter()
        server.warmup(np.asarray(first))
        t_warm = time.perf_counter() - t
        s_mean, s_ci, s_x = [], [], []
        for i, f in enumerate(frames):
            frame = np.asarray(imageio.read_image(os.path.join(us_te, f)).data)
            m, c, _ = server.handle_frame(frame, i)
            s_mean.append(m)
            s_ci.append(c)
            col = frame.reshape(-1).astype(np.float64) / 255.0
            s_x.append(basis64.T @ (col - mean64))
        serve_lat = np.asarray(server.latencies)
        server.flush_latencies()
        s_mean_ref, s_ci_ref = _host_predict(model, np.stack(s_x))
        e_serve = _rel(np.stack(s_mean), s_mean_ref)
        e_serve_ci = _rel(np.asarray(s_ci), s_ci_ref)

    ms = lambda a, p: f"{1e3 * float(np.percentile(a, p)):.3f}"
    _say("study", n_train=n_train, n_test=n_test, us=us_shape, dvf=dvf_shape,
         data_s=f"{t_data:.1f}", learn_s=f"{t_learn:.2f}",
         predict_s=f"{t_predict:.2f}", serve_warmup_s=f"{t_warm:.2f}")
    _say("study", predict_frame_ms_p50=ms(lat, 50), p99=ms(lat, 99),
         max=f"{1e3 * lat.max():.3f}", serve_frame_ms_p50=ms(serve_lat, 50),
         serve_p99=ms(serve_lat, 99))
    _say("study", feature_err=f"{e_feat:.3e}<={TOL_STUDY}",
         ci_err=f"{e_ci:.3e}<={TOL_STUDY}",
         serve_feature_err=f"{e_serve:.3e}<={TOL_STUDY}",
         serve_ci_err=f"{e_serve_ci:.3e}<={TOL_STUDY}")
    for name, e in (("predicted features", e_feat), ("credible interval", e_ci),
                    ("served features", e_serve), ("served interval", e_serve_ci)):
        _check(np.isfinite(e) and e <= TOL_STUDY, f"{name} error {e}")
    return {"feature_err": e_feat, "ci_err": e_ci, "serve_feature_err": e_serve,
            "serve_ci_err": e_serve_ci, "predict_latency_s": lat}


def _fleet_data(B, n, d, q, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, n, d)).astype(F32)
    Y = (np.sin(X.sum(-1, keepdims=True))
         + 0.1 * rng.standard_normal((B, n, q))).astype(F32)
    return X, Y


def _fleet_reference(X, Y, ell, noise):
    """Per-member float64 fits on the default device: alpha (B, n, q)."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True):
        one = lambda x, y: _reference_fit(x, y, ell, 1.0, noise)[1]
        return np.asarray(jax.jit(jax.vmap(one))(
            jnp.asarray(X, jnp.float64), jnp.asarray(Y, jnp.float64)))


def phase_fleet(B: int = 128, n: int = 512, d: int = 8, q: int = 2,
                seed: int = 2, ell: float = 2.0, noise: float = 0.1) -> dict:
    """``fit_batched`` against per-member float64 solves."""
    import jax
    import jax.numpy as jnp

    X, Y = _fleet_data(B, n, d, q, seed)
    kernel = gpr_tpu.Gaussian(jnp.float32(ell), jnp.float32(1.0))
    fit = jax.jit(gpr_tpu.fit_batched)
    args = (kernel, jnp.asarray(X), jnp.asarray(Y), jnp.float32(noise))
    fleet, t_first = _timed(fit, *args)
    fleet, t_fit = _timed(fit, *args)
    _check(fleet.alpha.dtype == jnp.float32, f"fleet alpha {fleet.alpha.dtype}")
    a64 = _fleet_reference(X, Y, ell, noise)
    err = max(_rel(fleet.alpha[b], a64[b]) for b in range(B))
    _say("fleet", B=B, n=n, d=d, q=q, alpha_err=f"{err:.3e}<={TOL_FLEET}",
         first_s=f"{t_first:.3f}", fit_s=f"{t_fit:.5f}",
         fits_per_s=f"{B / t_fit:.1f}")
    _check(np.isfinite(err) and err <= TOL_FLEET, f"fleet alpha error {err}")
    return {"alpha_err": err, "fit_s": t_fit}


def phase_sampler(n: int = 256, d: int = 3, chains: int = 4, warmup: int = 8,
                  samples: int = 8, seed: int = 3, noise: float = 0.2) -> dict:
    """``mll_scalar`` value and gradient against float64; a few chunked
    HMC and NUTS transitions, all finite."""
    import jax
    import jax.numpy as jnp
    from gpr_tpu.gp import likelihood as lk
    from gpr_tpu.inference.hmc import make_gp_log_posterior

    rng = np.random.default_rng(seed)
    Xh = rng.uniform(-3, 3, (n, d))
    Yh = np.sin(Xh.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((n, 1))

    def vg(X, Y, dt):
        f = lambda p: lk.mll_scalar(gpr_tpu.Gaussian(p[0], p[1]), X, Y, noise)
        return jax.jit(jax.value_and_grad(f))(jnp.asarray([1.3, 0.9], dt))

    (v, g), t_vg = _timed(vg, jnp.asarray(Xh, jnp.float32),
                          jnp.asarray(Yh, jnp.float32), jnp.float32)
    _check(v.dtype == jnp.float32, f"mll is {v.dtype}")
    with jax.enable_x64(True):
        v64, g64 = vg(jnp.asarray(Xh), jnp.asarray(Yh), jnp.float64)
        v64, g64 = float(v64), np.asarray(g64)
    e_v = abs(float(v) - v64) / abs(v64)
    e_g = _rel(g, g64)
    _say("sampler", n=n, mll_err=f"{e_v:.3e}<={TOL_MLL}",
         grad_err=f"{e_g:.3e}<={TOL_MLL_GRAD}", value_and_grad_s=f"{t_vg:.3f}")
    _check(e_v <= TOL_MLL, f"mll value error {e_v}")
    _check(e_g <= TOL_MLL_GRAD, f"mll gradient error {e_g}")

    logp = make_gp_log_posterior(
        gpr_tpu.Gaussian(1.0, 1.0), jnp.asarray(Xh, jnp.float32),
        jnp.asarray(Yh, jnp.float32), noise)
    z0 = jnp.zeros((chains, 2), jnp.float32)
    t0 = time.perf_counter()
    hmc = gpr_tpu.sample_hmc_chunked(
        logp, z0, jax.random.PRNGKey(seed),
        gpr_tpu.HMCConfig(num_warmup=warmup, num_samples=samples,
                          num_leapfrog=4),
        chunk_size=4)
    hmc_ok = bool(jnp.all(jnp.isfinite(hmc.samples)))
    t_hmc = time.perf_counter() - t0
    t0 = time.perf_counter()
    nuts = gpr_tpu.sample_nuts_chunked(
        logp, z0, jax.random.PRNGKey(seed + 1),
        gpr_tpu.NUTSConfig(num_warmup=warmup, num_samples=samples, max_depth=4),
        chunk_size=4)
    nuts_ok = bool(jnp.all(jnp.isfinite(nuts.samples)))
    t_nuts = time.perf_counter() - t0
    _say("sampler", chains=chains, hmc_draws=hmc.samples.shape,
         hmc_finite=hmc_ok, hmc_s=f"{t_hmc:.2f}", nuts_draws=nuts.samples.shape,
         nuts_finite=nuts_ok, nuts_s=f"{t_nuts:.2f}")
    _check(hmc.samples.shape == (chains, samples, 2), "HMC draw shape")
    _check(hmc_ok and nuts_ok, "non-finite sampler draws")
    return {"mll_err": e_v, "grad_err": e_g}


def phase_multi(n: int = 32768, d: int = 8, q: int = 2, n_devices: int = 4,
                seed: int = 4, ell: float = 1.0, noise: float = 0.3,
                fleet=(128, 512, 8, 2)) -> dict:
    """The sharded paths over ``n_devices`` devices against one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from gpr_tpu.gp.batched import fit_batched_sharded
    from gpr_tpu.parallel.sharded_gram import fit_sharded
    from gpr_tpu.parallel.sharded_hmc import sample_hmc_sharded_chunked

    devs = jax.devices()[:n_devices]
    _check(len(devs) == n_devices, f"need {n_devices} devices, have {len(devs)}")
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(F32)
    Y = (np.sin(X.sum(-1, keepdims=True))
         + 0.1 * rng.standard_normal((n, q))).astype(F32)
    kernel = gpr_tpu.Gaussian(jnp.float32(ell), jnp.float32(1.0))
    mesh = Mesh(np.array(devs), ("data",))
    fit = jax.jit(lambda X, Y: fit_sharded(kernel, X, Y, jnp.float32(noise),
                                           mesh, "data"))
    (alpha, logdet, _), t_first = _timed(fit, jnp.asarray(X), jnp.asarray(Y))
    (alpha, logdet, _), t_fit = _timed(fit, jnp.asarray(X), jnp.asarray(Y))
    _check(alpha.dtype == jnp.float32, f"sharded alpha {alpha.dtype}")
    with jax.enable_x64(True):
        L64, a64 = jax.jit(_reference_fit)(
            jax.device_put(X.astype(np.float64), devs[0]),
            jax.device_put(Y.astype(np.float64), devs[0]), ell, 1.0, noise)
        logdet64 = float(2.0 * jnp.sum(jnp.log(jnp.diagonal(L64))))
        a64 = np.asarray(a64)
        del L64
    e_alpha = _rel(alpha, a64)
    e_logdet = abs(float(logdet) - logdet64) / abs(logdet64)
    _say("multi", devices=n_devices, n=n, d=d,
         alpha_err=f"{e_alpha:.3e}<={TOL_FIT}",
         logdet_err=f"{e_logdet:.3e}<={TOL_LOGDET}",
         first_s=f"{t_first:.3f}", fit_s=f"{t_fit:.4f}")
    _check(e_alpha <= TOL_FIT, f"sharded alpha error {e_alpha}")
    _check(e_logdet <= TOL_LOGDET, f"sharded logdet error {e_logdet}")

    # chain-sharded chunked HMC against the one-device chunked sampler
    dim = 3
    scales = jnp.arange(1, dim + 1, dtype=jnp.float32)
    logp = lambda z: -0.5 * jnp.sum(scales * z * z)
    cfg = gpr_tpu.HMCConfig(num_warmup=8, num_samples=8, num_leapfrog=4,
                            jitter_steps=False)
    z0 = jnp.zeros((2 * n_devices, dim), jnp.float32)
    key = jax.random.PRNGKey(seed)
    chains = Mesh(np.array(devs), ("chains",))
    sh = sample_hmc_sharded_chunked(logp, z0, key, cfg, chunk_size=4, mesh=chains)
    one = gpr_tpu.sample_hmc_chunked(logp, z0, key, cfg, chunk_size=4)
    diff = float(np.max(np.abs(np.asarray(sh.samples) - np.asarray(one.samples))))
    _say("multi", hmc_chains=2 * n_devices,
         hmc_max_abs_diff=f"{diff:.3e}<={TOL_SAMPLER_PARITY}")
    _check(diff <= TOL_SAMPLER_PARITY, f"sharded HMC draws differ by {diff}")

    B, fn, fd, fq = fleet
    Xf, Yf = _fleet_data(B, fn, fd, fq, seed)
    kf = gpr_tpu.Gaussian(jnp.float32(2.0), jnp.float32(1.0))
    t0 = time.perf_counter()
    fs = fit_batched_sharded(kf, Xf, Yf, 0.1, mesh=chains, axis="chains")
    jax.block_until_ready(fs.alpha)
    t_fs = time.perf_counter() - t0
    ref = gpr_tpu.fit_batched(kf, jnp.asarray(Xf), jnp.asarray(Yf), 0.1)
    e_fleet = _rel(fs.alpha, ref.alpha)
    _say("multi", fleet_B=B, fleet_n=fn, fleet_alpha_err=f"{e_fleet:.3e}<={TOL_FIT}",
         fleet_first_s=f"{t_fs:.3f}")
    _check(e_fleet <= TOL_FIT, f"sharded fleet alpha error {e_fleet}")
    return {"alpha_err": e_alpha, "logdet_err": e_logdet, "hmc_diff": diff,
            "fleet_err": e_fleet}


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded paths over four cards")
    args = ap.parse_args(argv)
    setup_compile_cache()
    import jax

    dev = phase_device("gpu")
    print(f"nvidia-smi: {_nvidia_smi()}", flush=True)
    if args.multi:
        phases = [("multi", phase_multi)]
    else:
        phases = [("fit", phase_fit), ("escalation", phase_escalation),
                  ("study", phase_study), ("fleet", phase_fleet),
                  ("sampler", phase_sampler)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # report every phase; any failure fails the run
            traceback.print_exc()
            failed.append(name)
        status = "FAILED" if name in failed else "ok"
        print(f"phase {name} {status} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    if failed:
        print(f"failed phases: {', '.join(failed)}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
