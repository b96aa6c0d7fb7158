"""Training app — the reference's ``gpLearn`` binary re-built on JAX.

Same CLI contract (reference apps/GaussianProcessLearn.cpp:70-73):

    python -m gpr_tpu.apps.learn <config_model.json> <config_learn.json> \\
        gpr_prefix input_folder output_folder [ar_folder]

Reads the kernel-string + data-noise from config_model, extracts PCA(+AR)
features via the DataParser, trains the exact GP in ONE jitted
Gram+Cholesky+solve step (instead of the reference's AddSample loop +
explicit inversion, GaussianProcessLearn.cpp:141-151), and writes the
5-file model artifact set plus per-stage timing to the log file.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    """The CLI runs in float64, as the reference does: in float32 the
    credible interval's k(x,x) - k^T (K + s^2 I)^-1 k cancels to noise at
    the study's noise level (PERF.md)."""
    import jax

    with jax.enable_x64(True):
        return _main(sys.argv[1:] if argv is None else argv)


def _main(argv) -> int:
    print("\nGaussian process training app:")
    if len(argv) not in (5, 6):
        print(
            "Usage: learn <path/to/config_model.json> <path/to/config_learn.json>"
            " gpr_prefix input_folder output_folder [ar_folder]"
        )
        return -1

    with open(argv[0]) as f:
        config_model = json.load(f)
    with open(argv[1]) as f:
        config_learn = json.load(f)
    gpr_prefix, input_folder, output_folder = argv[2:5]
    if config_model["perform_ar"]:
        if len(argv) < 6:
            print("Error: perform_ar is set but no ar_folder argument given")
            return -1
        ar_folder = argv[5]
    else:
        ar_folder = ""

    kernel_string = config_model["kernel_string"]

    from ..utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    data_noise = float(config_model["data_noise"])

    from ..utils.logutils import get_current_date_time, write_to_log_file

    log = gpr_prefix + "-log_"
    write_to_log_file(log, "\n" + get_current_date_time("now"))
    write_to_log_file(log, "Gaussian process training app:")
    write_to_log_file(log, f" - kernel string: {kernel_string}")
    write_to_log_file(log, f" - data noise: {data_noise}")

    try:
        import gpr_tpu
        from ..pipeline.dataparser import DataParser

        t0 = time.perf_counter()
        kernel = gpr_tpu.parse_kernel(kernel_string)
        print(f"Initialize Gaussian process... {time.perf_counter()-t0:.3f}s [done]")

        t0 = time.perf_counter()
        parser = DataParser.for_training(
            input_folder, output_folder, ar_folder, gpr_prefix,
            config_model, config_learn,
        )
        pairs = parser.get_training_data()
        dt = time.perf_counter() - t0
        print(f"Parse data and perform PCA... {dt:.3f}s [done]")
        write_to_log_file(log, f"elapsed time: {dt} [PCA successfully completed]")

        t0 = time.perf_counter()
        X = np.stack([p[0] for p in pairs])
        Y = np.stack([p[1] for p in pairs])
        import jax

        # optional sparse mode (config extension beyond the reference):
        # "sparse_inducing": m  trains an inducing-point GP for large n
        m_inducing = int(config_model.get("sparse_inducing", 0))
        if m_inducing > 0 and m_inducing < X.shape[0]:
            from ..gp import sparse as sparse_mod

            idx = np.linspace(0, X.shape[0] - 1, m_inducing).astype(int)
            sgp = sparse_mod.fit_sparse(
                kernel, X[idx], X, Y, sigma=data_noise, jitter=1e-8
            )
            jax.block_until_ready(sgp.alpha)
            dt = time.perf_counter() - t0
            print(f"Perform training (sparse, m={m_inducing})... {dt:.3f}s [done]")
            write_to_log_file(
                log,
                f"Perform training (sparse)...  elapsed time: {dt} "
                "[successfully completed]",
            )
            t0 = time.perf_counter()
            sparse_mod.save_sparse(sgp, gpr_prefix + "-sparse.npz")
            print(f"Saving sparse GP... {time.perf_counter()-t0:.3f}s [done]")
            return 0

        gp = gpr_tpu.fit(kernel, X, Y, sigma=data_noise)
        jax.block_until_ready(gp.alpha)
        dt = time.perf_counter() - t0
        print(f"Perform training... {dt:.3f}s [done]")
        write_to_log_file(
            log, f"Perform training...  elapsed time: {dt} [successfully completed]"
        )

        t0 = time.perf_counter()
        gp.save(gpr_prefix)
        print(f"Saving Gaussian process... {time.perf_counter()-t0:.3f}s [done]")
        return 0
    except (ValueError, OSError, KeyError) as e:
        print(f"\nError: {e}")
        return -1


if __name__ == "__main__":
    sys.exit(main())
