"""Real-time serving loop: watch a directory for ultrasound frames, emit
predicted DVF features/fields with per-frame latency accounting.

The production counterpart of the reference's offline per-frame timing
study (reference apps/GaussianProcessPredict.cpp:185-194 measures the loop
it never deploys).  One process: the GP + PCA basis load once, the
predict program compiles once, then every arriving frame runs
feature-extraction -> GP -> (optional) reconstruction and appends to the
latency log.  No external dependencies — plain polling, suitable for a
shared-filesystem acquisition pipeline.

    python -m gpr_tpu.apps.serve <config_model.json> gpr_prefix watch_dir out_dir
        [--poll 0.02] [--max-frames N] [--features-only]
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional, Set

import numpy as np


class Server:
    def __init__(
        self,
        config_model: dict,
        gpr_prefix: str,
        out_dir: str,
        features_only: bool = False,
    ):
        import jax
        import gpr_tpu
        from ..pipeline import pca as pcamod

        self.n_input_modes = int(config_model["n_inputModes"])
        self.n_output_modes = int(config_model["n_outputModes"])
        self.out_dir = out_dir
        self.features_only = features_only
        self.prefix = gpr_prefix

        self.gp = gpr_tpu.load(gpr_prefix)
        self.in_pca = pcamod.load_pca(gpr_prefix + "-input")
        self.out_pca = pcamod.load_pca(gpr_prefix + "-output")
        self._jax = jax
        self.latencies: list = []
        os.makedirs(out_dir, exist_ok=True)

        # the ENTIRE per-frame path — feature projection, GP predict +
        # credible interval, inverse-PCA reconstruction — is ONE jitted
        # program returning ONE packed vector: one device dispatch and one
        # host fetch per frame, on a path whose compute is sub-millisecond.
        import jax.numpy as jnp

        n_in, n_out = self.n_input_modes, self.n_output_modes
        with_dvf = not features_only

        def pipe(gp, in_pca, out_pca, col):
            feats = in_pca.reduce(col, n_in)[:, 0]
            mean = gp.predict(feats)
            ci = gp.credible_interval(feats)
            parts = [jnp.reshape(mean, (-1,)), jnp.reshape(ci, (1,))]
            if with_dvf:
                parts.append(
                    out_pca.reconstruct(mean[:n_out, None], n_out)[:, 0]
                )
            dt = jnp.result_type(*(p.dtype for p in parts))
            return jnp.concatenate([p.astype(dt) for p in parts])

        self._pipeline = jax.jit(pipe)

    def warmup(self, example_frame: np.ndarray) -> None:
        col = self._frame_col(example_frame)
        self._jax.block_until_ready(
            self._pipeline(self.gp, self.in_pca, self.out_pca, col)
        )

    @staticmethod
    def _frame_col(frame: np.ndarray) -> np.ndarray:
        return frame.reshape(-1, 1).astype(np.float64) / 255.0

    def handle_frame(self, frame: np.ndarray, index: int):
        """One frame through the pipeline; returns (mean_features, ci)."""
        t0 = time.perf_counter()
        col = self._frame_col(frame)
        out = np.asarray(
            self._pipeline(self.gp, self.in_pca, self.out_pca, col)
        )
        if self.features_only:
            mean, ci = out[:-1], float(out[-1])
        else:
            d_out = int(self.out_pca.mean.shape[0])
            mean = out[: out.size - 1 - d_out]
            ci = float(out[out.size - 1 - d_out])
            dvf = out[out.size - d_out :]
            np.save(os.path.join(self.out_dir, f"dvf{index:05d}.npy"), dvf)
        dt = time.perf_counter() - t0
        self.latencies.append(dt)
        return mean, ci, dt

    def flush_latencies(self) -> None:
        with open(self.prefix + "-latestInferenceTime.txt", "a") as f:
            for dt in self.latencies:
                f.write(f"{dt},")
        self.latencies.clear()


def watch(
    server: Server,
    watch_dir: str,
    poll: float = 0.02,
    max_frames: Optional[int] = None,
    idle_timeout: float = 10.0,
) -> int:
    """Poll ``watch_dir`` for new image files, serve them in arrival order.
    Returns the number of frames served (stops after ``max_frames`` or
    ``idle_timeout`` seconds without new files)."""
    from ..pipeline import imageio

    seen: Set[str] = set()
    served = 0
    warmed = False
    last_new = time.monotonic()
    try:
        while True:
            files = sorted(
                f
                for f in os.listdir(watch_dir)
                if f not in seen and f.endswith((".vtk", ".png", ".mha"))
            )
            if files:
                last_new = time.monotonic()
            for f in files:
                path = os.path.join(watch_dir, f)
                try:
                    frame = imageio.read_image(path).data
                except Exception:
                    # acquisition may still be writing the file; retry once
                    # after a settle instead of killing the serving loop
                    time.sleep(max(poll, 0.05))
                    try:
                        frame = imageio.read_image(path).data
                    except Exception as e:
                        print(f"serve: skipping unreadable frame {f}: {e}",
                              file=sys.stderr)
                        seen.add(f)
                        continue
                seen.add(f)
                arr = np.asarray(frame)
                if not warmed:
                    # compile OUTSIDE the timed path: frame 0's latency must
                    # not record the one-time jit compile
                    server.warmup(arr)
                    warmed = True
                server.handle_frame(arr, served)
                served += 1
                if max_frames is not None and served >= max_frames:
                    return served
            if time.monotonic() - last_new > idle_timeout:
                return served
            time.sleep(poll)
    finally:
        # a crash mid-session must not lose the accumulated timings
        server.flush_latencies()


def main(argv=None) -> int:
    """The CLI runs in float64, as the reference does: in float32 the
    credible interval's k(x,x) - k^T (K + s^2 I)^-1 k cancels to noise at
    the study's noise level (PERF.md)."""
    import jax

    with jax.enable_x64(True):
        return _main(sys.argv[1:] if argv is None else argv)


def _main(argv) -> int:
    if len(argv) < 4:
        print(
            "Usage: serve <config_model.json> gpr_prefix watch_dir out_dir"
            " [--poll s] [--max-frames N] [--features-only]"
        )
        return -1
    with open(argv[0]) as f:
        config_model = json.load(f)
    gpr_prefix, watch_dir, out_dir = argv[1:4]

    from ..utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    poll = float(argv[argv.index("--poll") + 1]) if "--poll" in argv else 0.02
    max_frames = (
        int(argv[argv.index("--max-frames") + 1]) if "--max-frames" in argv else None
    )
    server = Server(
        config_model, gpr_prefix, out_dir, features_only="--features-only" in argv
    )
    n = watch(server, watch_dir, poll=poll, max_frames=max_frames)
    print(f"served {n} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
