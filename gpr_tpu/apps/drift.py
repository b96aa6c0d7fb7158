"""Drift analysis: retrain on sliding training windows, compare error
percentiles across windows.

Re-design of the reference's drift study (reference
scripts/drift_analysis.sh:42-50 — a bash loop rewriting
``start_trainInd``/``n_trainImgs`` and re-running the pipeline — plus
scripts/validation_drift.py:31-77 comparing percentile curves).  Here the
window loop runs in-process: one Python runtime, the GP retrains per
window (the jit cache makes repeated same-shape training cheap), and the
result is a single JSON of percentile statistics per window.

    python -m gpr_tpu.apps.drift <config.yaml> <n_train> <start0,start1,...>
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Sequence


def run_drift(
    config_path: str, n_train: int, starts: Sequence[int]
) -> Dict[str, Dict]:
    import yaml

    from . import learn, predict, validate

    with open(config_path) as f:
        cfg = yaml.safe_load(f)
    general = cfg.get("general", {})
    root = general.get("root_dir", os.path.dirname(os.path.abspath(config_path)))
    reg_dir = os.path.join(root, general.get("registration_dir", "reg3d"))
    surrogate_dir = os.path.join(root, general.get("surrogate_dir", "us"))
    subdir = cfg.get("gpr_model", {}).get("subdir", "test")
    master = os.path.join(root, general.get("master_volume", ""))

    results: Dict[str, Dict] = {}
    for start in starts:
        tag = f"win{start:04d}"
        gpr_dir = os.path.join(reg_dir, f"gpr_{tag}")
        result_dir = os.path.join(reg_dir, f"{subdir}_pred_{tag}")
        os.makedirs(gpr_dir, exist_ok=True)
        os.makedirs(result_dir, exist_ok=True)

        cfg_learn = dict(
            cfg.get("gpr_learn", {}), n_trainImgs=n_train, start_trainInd=start
        )
        cm = os.path.join(gpr_dir, "config_model.json")
        cl = os.path.join(gpr_dir, "config_learn.json")
        cp = os.path.join(gpr_dir, "config_predict.json")
        json.dump(cfg.get("gpr_model", {}), open(cm, "w"))
        json.dump(cfg_learn, open(cl, "w"))
        json.dump(cfg.get("gpr_predict", {}), open(cp, "w"))

        prefix = os.path.join(gpr_dir, "gpr")
        rc = learn.main(
            [cm, cl, prefix, os.path.join(surrogate_dir, "train"),
             os.path.join(reg_dir, "train"),
             os.path.join(root, general.get("ar_dir", "ar"))]
        )
        if rc != 0:
            raise RuntimeError(f"drift window {start}: learn failed ({rc})")
        rc = predict.main(
            [cm, cp, prefix, os.path.join(surrogate_dir, subdir),
             os.path.join(reg_dir, subdir), result_dir, master]
        )
        if rc != 0:
            raise RuntimeError(f"drift window {start}: predict failed ({rc})")

        stats = validate.dvf_error(os.path.join(reg_dir, subdir), result_dir)
        results[tag] = {
            "start": start,
            "n_train": n_train,
            "percentiles": {str(k): v for k, v in stats["percentiles"].items()},
            "median_per_frame": stats["median_per_frame"].tolist(),
        }
    return results


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print("Usage: drift <config.yaml> <n_trainImgs> <start0,start1,...>")
        return -1
    config_path = argv[0]
    n_train = int(argv[1])
    starts = [int(s) for s in argv[2].split(",")]
    from ..utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    results = run_drift(config_path, n_train, starts)
    # write into the study's root_dir (NOT next to the config — configs
    # ship in the repo and run output must not dirty the working tree)
    import yaml

    with open(config_path) as f:
        _cfg = yaml.safe_load(f)
    _root = _cfg.get("general", {}).get(
        "root_dir", os.path.dirname(os.path.abspath(config_path))
    )
    # a relative root_dir is relative to the CONFIG, not the CWD (the
    # reference resolves paths against the yaml's location too), and the
    # study dir may not exist yet on a fresh run
    if not os.path.isabs(_root):
        _root = os.path.join(os.path.dirname(os.path.abspath(config_path)), _root)
    os.makedirs(_root, exist_ok=True)
    out = os.path.join(_root, "drift.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    for tag, r in results.items():
        p = r["percentiles"]
        print(f"{tag}: 50%={p['50']:.4f} 95%={p['95']:.4f} 99%={p['99']:.4f}")
    print(f"written: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
