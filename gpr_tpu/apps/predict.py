"""Inference app — the reference's ``gpPredict`` binary re-built on JAX.

Same CLI contract (reference apps/GaussianProcessPredict.cpp:110-113):

    python -m gpr_tpu.apps.predict <config_model.json> <config_predict.json> \\
        gpr_prefix input_folder groundtruth_folder result_folder reference_file

Per-frame GP prediction + credible interval with wall-clock timing written
to ``{prefix}-latestInferenceTime.txt`` (reference :185-194), PCA latency to
``{prefix}-latestCompTimePCA.txt``, credible intervals to
``{prefix}-credibleInterval.csv``, and predicted DVFs as
``result_folder/dfPred%05d.vtk`` (reference SavePrediction, :55-94).

Difference from the reference: the per-frame predict is ONE jitted kernel-vector +
GEMV (+ posterior-variance) program, compiled once and reused for every
frame — the latency-critical real-time path.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def save_prediction(vectors, output_dir: str, reference_file: str) -> None:
    """Write each reconstructed DVF as dfPred%05d.vtk with the reference
    volume's geometry (reference SavePrediction,
    apps/GaussianProcessPredict.cpp:55-94)."""
    from ..pipeline import imageio

    ref = imageio.read_image(reference_file)
    # the reference binary is 3-D-only (hardcodes 3 components); follow
    # the master volume instead so 2-D+t tracking fields round-trip
    # (examples/params/matrix/config_tracking_2d.yaml)
    n_comp = ref.ncomponents if ref.ncomponents > 1 else 3
    for i, v in enumerate(vectors):
        npix = np.asarray(v).size // n_comp
        shape = ref.data.shape[: -1] if ref.ncomponents > 1 else ref.data.shape
        img = imageio.Image(
            data=np.asarray(v).reshape(*shape, n_comp)
            if int(np.prod(shape)) == npix
            else np.asarray(v).reshape(-1, n_comp)[None],
            spacing=ref.spacing,
            origin=ref.origin,
            ncomponents=n_comp,
        )
        imageio.write_image(img, os.path.join(output_dir, f"dfPred{i:05d}.vtk"))


def _append_csv_row(path: str, values) -> None:
    """Trailing-comma single-line append (reference WriteVectorToFile,
    apps/GaussianProcessPredict.cpp:96-105)."""
    with open(path, "a") as f:
        for v in values:
            f.write(f"{v},")


def main(argv=None) -> int:
    """The CLI runs in float64, as the reference does: in float32 the
    credible interval's k(x,x) - k^T (K + s^2 I)^-1 k cancels to noise at
    the study's noise level (PERF.md)."""
    import jax

    with jax.enable_x64(True):
        return _main(sys.argv[1:] if argv is None else argv)


def _main(argv) -> int:
    print("\nGaussian process prediction app:")
    if len(argv) != 7:
        print(
            "Usage: predict <path/to/config_model.json> <path/to/config_predict.json>"
            " gpr_prefix input_folder groundtruth_folder result_folder reference_file"
        )
        return -1

    with open(argv[0]) as f:
        config_model = json.load(f)
    with open(argv[1]) as f:
        config_predict = json.load(f)
    gpr_prefix, input_folder, gt_folder, result_folder, reference_file = argv[2:7]

    from ..utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    from ..utils.logutils import get_current_date_time, write_to_log_file

    log = gpr_prefix + "-log_"
    write_to_log_file(log, "\n" + get_current_date_time("now"))
    write_to_log_file(log, "Gaussian process prediction app")

    try:
        import jax
        import gpr_tpu
        from ..pipeline.dataparser import DataParser

        t0 = time.perf_counter()
        sparse_path = gpr_prefix + "-sparse.npz"
        if os.path.exists(sparse_path):
            from ..gp import sparse as sparse_mod

            gp = sparse_mod.load_sparse(sparse_path)
            print(
                f"Initialize sparse Gaussian process... "
                f"{time.perf_counter()-t0:.3f}s [done]"
            )
        else:
            gp = gpr_tpu.load(gpr_prefix)
            print(
                f"Initialize Gaussian process... {time.perf_counter()-t0:.3f}s [done]"
            )

        t0 = time.perf_counter()
        parser = DataParser.for_prediction(
            input_folder, gt_folder, gpr_prefix, config_model, config_predict
        )
        test_vectors = parser.get_test_data()
        dt = time.perf_counter() - t0
        print(f"Parse data and extract PCA features... {dt:.3f}s [done]")
        write_to_log_file(log, f"elapsed time: {dt} [PCA successfully completed]")

        # one compiled program for the whole real-time loop, returning ONE
        # packed vector [mean..., ci] so each frame costs exactly one
        # device dispatch and one host fetch
        import jax.numpy as jnp

        def _packed(g, x):
            mean = g.predict(x)
            ci = g.credible_interval(x)
            dt = jnp.result_type(mean.dtype, ci.dtype)
            return jnp.concatenate(
                [jnp.reshape(mean, (-1,)).astype(dt),
                 jnp.reshape(ci, (1,)).astype(dt)]
            )

        predict_fn = jax.jit(_packed)
        # warm up the compilation outside the timed loop (skip gracefully
        # when the input folder held no frames — the loop below writes the
        # empty artifact set like the reference)
        if test_vectors:
            _ = jax.block_until_ready(predict_fn(gp, np.asarray(test_vectors[0])))

        predicted, confidence, times = [], [], []
        print("GP prediction done in (s):")
        for v in test_vectors:
            t0 = time.perf_counter()
            out = np.asarray(predict_fn(gp, np.asarray(v)))
            dt = time.perf_counter() - t0
            predicted.append(out[:-1])
            confidence.append(float(out[-1]))
            times.append(dt)
            print(dt)
        _append_csv_row(gpr_prefix + "-latestInferenceTime.txt", times)

        t0 = time.perf_counter()
        output_vectors = parser.get_results(predicted)
        print(
            "Reconstruct output from principal components... "
            f"{time.perf_counter()-t0:.3f}s [done]"
        )

        comp_time = parser.get_computation_time()
        _append_csv_row(gpr_prefix + "-latestCompTimePCA.txt", comp_time)

        t0 = time.perf_counter()
        save_prediction(output_vectors, result_folder, reference_file)
        print(f"Save results... {time.perf_counter()-t0:.3f}s [done]")
        _append_csv_row(gpr_prefix + "-credibleInterval.csv", confidence)
        return 0
    except (ValueError, OSError, KeyError) as e:
        print(f"Error: {e}")
        return -1


if __name__ == "__main__":
    sys.exit(main())
