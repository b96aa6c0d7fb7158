"""Experiment orchestration — the reference's ``scripts/main.py`` /
``run_experiments.py`` layer (reference scripts/main.py:53-405) rebuilt
without process boundaries.

The reference drives each stage by ``os.system`` on external binaries and
re-serializes its YAML into per-stage JSON configs (main.py:269-330).  Here
the regression/evaluation stages call the in-process apps directly (one
Python runtime, one jit cache), while preprocessing/registration/stacking
— which depend on external registration executables the reference does not
ship (``gdr``, ``ims4dMRI``, config.yaml:12-17) — are gated behind the same
``options:`` flags and invoked via subprocess only when their executables
are configured.

    python -m gpr_tpu.apps.experiments <config.yaml>
    python -m gpr_tpu.apps.experiments <dir_of_yamls>   (run_experiments)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import List


def _load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def run_experiment(config_path: str) -> int:
    cfg = _load_yaml(config_path)
    opt = cfg.get("options", {})
    general = cfg.get("general", {})
    exe = cfg.get("exe", {})
    root = general.get("root_dir", os.path.dirname(os.path.abspath(config_path)))

    # --- preprocessing: DICOM rename/fix/sort (reference main.py:77-113) ---
    if opt.get("preprocessing"):
        from ..data.dicom import preprocess_dicom_dir

        print("PREPROCESSING DATA FILES...")
        data_in = os.path.join(root, general.get("data_dir", "data"))
        if not os.path.exists(data_in):
            print("Path to data files does not exist.")
            return -1
        preprocess_dicom_dir(
            data_in,
            data_in + "_mod",
            n_slices=int(general.get("n_slices", 0)),
            is_navi=False,
        )
        print("[done]")
        if general.get("surrogate_type", 0) in (0, 2):
            print("PREPROCESSING NAVIS...")
            navi_in = os.path.join(root, general.get("navi_dir", "navi"))
            if not os.path.exists(navi_in):
                print("Path to navigators does not exist.")
                return -1
            preprocess_dicom_dir(navi_in, navi_in + "_mod", is_navi=True)
            print("[done]")

    # --- external preprocessing stages (process boundary preserved) --------
    for stage, flag in (
        ("registration_2d", "registration_2d"),
        ("stacking", "stacking"),
        ("registration_3d", "registration_3d"),
    ):
        if opt.get(flag) and exe.get(stage):
            args = [exe[stage]] + [str(a) for a in cfg.get(stage.split("_")[0], [])]
            print(f"{stage.upper()}... ({args[0]})")
            rc = subprocess.call(args)
            if rc != 0:
                print(f"{stage} failed with {rc}")
                return rc

    # --- GP regression (in-process) ----------------------------------------
    reg_dir = os.path.join(root, general.get("registration_dir", "reg3d"))
    surrogate_dir = os.path.join(root, general.get("surrogate_dir", "us"))

    # --- splitting: sweep-count train/test split (main.py:217-263) ---------
    if opt.get("splitting_data") or (
        (opt.get("registration_2d") or opt.get("registration_3d"))
        and opt.get("regression")
    ):
        from ..data.prep import split_train_test

        print("SPLITTING...")
        n_slices = int(general.get("n_slices", 1))
        n_training_imgs = int(general.get("n_training_sweeps", 0)) * n_slices
        counts = split_train_test(
            {"surrogate": surrogate_dir, "dfs": reg_dir},
            n_training_imgs,
            {
                "surrogate": general.get("input_format", "png"),
                "dfs": general.get("output_format", "vtk"),
            },
        )
        for name, (n_tr, n_te) in counts.items():
            print(f"Splitting {name}: {n_tr} train / {n_te} test")
        print("[done]")
    subdir = cfg.get("gpr_model", {}).get("subdir", "test")
    gpr_dir = os.path.join(reg_dir, "gpr")
    gpr_prefix = os.path.join(gpr_dir, "gpr")
    result_dir = os.path.join(reg_dir, f"{subdir}_pred")

    cfg_model = os.path.join(root, "config_model.json")
    cfg_learn = os.path.join(root, "config_learn.json")
    cfg_predict = os.path.join(root, "config_predict.json")
    for path, section in (
        (cfg_model, "gpr_model"),
        (cfg_learn, "gpr_learn"),
        (cfg_predict, "gpr_predict"),
    ):
        with open(path, "w") as f:
            json.dump(cfg.get(section, {}), f)

    if opt.get("regression"):
        print("GP REGRESSION...")
        os.makedirs(gpr_dir, exist_ok=True)
        os.makedirs(result_dir, exist_ok=True)
        if not cfg.get("gpr_learn", {}).get("use_precomputed", False):
            for f in os.listdir(gpr_dir):
                os.remove(os.path.join(gpr_dir, f))
        for f in os.listdir(result_dir):
            os.remove(os.path.join(result_dir, f))

        from . import learn, predict

        rc = learn.main(
            [
                cfg_model,
                cfg_learn,
                gpr_prefix,
                os.path.join(surrogate_dir, "train"),
                os.path.join(reg_dir, "train"),
                os.path.join(root, general.get("ar_dir", "ar")),
            ]
        )
        if rc != 0:
            return rc
        rc = predict.main(
            [
                cfg_model,
                cfg_predict,
                gpr_prefix,
                os.path.join(surrogate_dir, subdir),
                os.path.join(reg_dir, subdir),
                result_dir,
                os.path.join(root, general.get("master_volume", "")),
            ]
        )
        if rc != 0:
            return rc
        print("[done]")

    # --- evaluation ---------------------------------------------------------
    if opt.get("evaluation"):
        print("EVALUATION...")
        from . import validate

        stats = validate.dvf_error(os.path.join(reg_dir, subdir), result_dir)
        for p, v in stats["percentiles"].items():
            print(f"{p}% percentile:\t{v:0.4f}")
        with open(os.path.join(root, "evaluation.json"), "w") as f:
            json.dump(
                {str(k): v for k, v in stats["percentiles"].items()}, f, indent=2
            )
        # the reference's fig5 artifact set (validation_dvf.py:110-198):
        # percentile bands + median error over time OVERLAID with the GP
        # credible interval read from gpr-credibleInterval.csv, plus the
        # errbars .npy companions
        from . import tikz

        tex_path = tikz.export_validation_tikz(
            root, stats, subdir=subdir,
            credible_csv=gpr_prefix + "-credibleInterval.csv",
        )
        print(f"plot artifact: {tex_path}")
        print("[done]")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("Usage: experiments <config.yaml | dir_of_yamls>")
        return -1
    target = argv[0]
    from ..utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    if os.path.isdir(target):
        # run_experiments.py semantics: iterate configs in a folder
        configs: List[str] = sorted(
            os.path.join(target, f)
            for f in os.listdir(target)
            if f.endswith((".yaml", ".yml"))
        )
        for c in configs:
            print(f"=== {c} ===")
            rc = run_experiment(c)
            if rc != 0:
                return rc
        return 0
    return run_experiment(target)


if __name__ == "__main__":
    sys.exit(main())
