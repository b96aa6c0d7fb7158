"""Regenerate docs/API.md: one line per public symbol of every gpr_tpu
module, in package order.  Run on the CPU backend:

    python tools/gen_api.py > docs/API.md
"""

import importlib
import inspect
import os
import pkgutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

MODULES = [
    "gpr_tpu.kernels.kernels", "gpr_tpu.kernels.dsl", "gpr_tpu.kernels.utils",
    "gpr_tpu.ops.linalg", "gpr_tpu.ops.blocked",
    "gpr_tpu.gp.exact", "gpr_tpu.gp.sparse", "gpr_tpu.gp.likelihood",
    "gpr_tpu.gp.batched",
    "gpr_tpu.inference.priors", "gpr_tpu.inference.optimize",
    "gpr_tpu.inference.hmc", "gpr_tpu.inference.nuts",
    "gpr_tpu.inference.advi",
    "gpr_tpu.inference.predictive", "gpr_tpu.inference.period",
    "gpr_tpu.inference.prior_utils",
    "gpr_tpu.parallel.sharded_gram", "gpr_tpu.parallel.sharded_hmc",
    "gpr_tpu.pipeline.pca", "gpr_tpu.pipeline.autoregression",
    "gpr_tpu.pipeline.imageio", "gpr_tpu.pipeline.filters",
    "gpr_tpu.pipeline.dataparser", "gpr_tpu.pipeline.warp",
    "gpr_tpu.pipeline.bspline",
    "gpr_tpu.data.prep", "gpr_tpu.data.dicom",
    "gpr_tpu.utils.matrixio", "gpr_tpu.utils.native", "gpr_tpu.utils.config",
    "gpr_tpu.utils.compile_cache",
    "gpr_tpu.utils.logutils", "gpr_tpu.utils.profiling",
    "gpr_tpu.apps.learn", "gpr_tpu.apps.predict", "gpr_tpu.apps.experiments",
    "gpr_tpu.apps.validate", "gpr_tpu.apps.drift", "gpr_tpu.apps.analysis",
    "gpr_tpu.apps.tikz", "gpr_tpu.apps.serve",
]


def _sig(obj):
    try:
        s = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    if len(s) > 70:
        s = s[:66] + "...)"
    return s


def _doc(obj):
    d = inspect.getdoc(obj) or ""
    return d.split("\n")[0][:110]


def main():
    out = sys.stdout
    out.write(
        "# API reference (generated)\n\n"
        "One line per public symbol; see module docstrings for the\n"
        "reference citations and design notes.  Regenerate with\n"
        "`python tools/gen_api.py > docs/API.md`.\n"
    )
    for name in MODULES:
        mod = importlib.import_module(name)
        lines = []
        for sym in sorted(vars(mod)):
            if sym.startswith("_"):
                continue
            obj = vars(mod)[sym]
            if getattr(obj, "__module__", None) != name:
                continue
            if inspect.isclass(obj):
                lines.append(f"- `class {sym}{_sig(obj)}` — {_doc(obj)}")
            elif inspect.isfunction(obj) or callable(obj):
                lines.append(f"- `def {sym}{_sig(obj)}` — {_doc(obj)}")
        if lines:
            out.write(f"\n## {name}\n\n")
            out.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
