"""North-star SPL/nDTW parity evaluation against a reference checkpoint, and
the one-command asset-day check of the loops on the card.

Port of scripts/eval_parity.py, with its flags, defaults, exit codes and log
lines. The north star is R2R val_unseen SPL/nDTW within 1 point of the
reference checkpoints (reference README.md:209-218); the whole flow also runs
on synthetic fixtures (tests/test_torch_eval_parity.py).

Stage 1 (always): the host-loop eval of the checkpoint, compared with
--expected-spl/--expected-ndtw.

Stage 2 (--resident): the scan eval on the card (EVAL.ON_DEVICE_SCAN) of the
SAME checkpoint on the SAME episodes, driving the asset pipeline first where
needed:

  * geometry import: if --geometry-dir has no .npz files, exports
    occupancy-grid twins with `vlnce_torch.scripts.export_scene_geometry`
    from --connectivity (the reference's connectivity_graphs.pkl,
    measures.py:336-337) or --habitat-geometry (navmesh sampling through
    habitat_sim);
  * feature bank: if --bank-dir has no .npz files, renders and encodes the
    features per (node, heading) with
    `vlnce_torch.scripts.generate_feature_bank`;
  * the scan eval over the imported geometry, with the bank's features in
    place of rendering when --bank-dir is given (CUDA.FEATURE_BANK_DIR),
    compared with BOTH the expected numbers and the stage-1 results
    (--resident-tolerance).

Usage:
    python -m vlnce_torch.scripts.eval_parity \\
        --exp-config vlnce_torch/config/experiments/r2r_baselines/cma_pm_da.yaml \\
        --checkpoint data/checkpoints/CMA_PM_DA_Aug.pth \\
        --expected-spl 0.27 --expected-ndtw 0.53 [--tolerance 0.01] \\
        [--resident --geometry-dir data/scene_geometry \\
         --connectivity data/connectivity_graphs.pkl \\
         --bank-dir data/feature_banks/r2r] \\
        [opts ...]

The checkpoint may be anything `utils/checkpoints.load_checkpoint` reads: a
`torch.save` file or a JAX package's msgpack checkpoint. The feature banks
are encoded by the policy that the opts give the generator (seeded, or
`IL.load_from_ckpt True IL.ckpt_to_load <file>`), as in the JAX script.
Exits 1 when a stats file already exists or any requested comparison exceeds
its tolerance.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random
import sys

import numpy as np


class _NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def add_video_from_np_images(self, *a, **k):
        pass


def _run_eval(config, checkpoint: str, registry):
    trainer = registry.get_trainer(config.TRAINER_NAME)(config)
    return trainer._eval_checkpoint(checkpoint, _NullWriter(), 0)


def _run_script(main_fn, module: str, argv, logger) -> None:
    """Run a sibling script's main(argv) in this process (the card and the
    built kernels are shared)."""
    logger.info("running: " + " ".join(["python", "-m", module] + list(argv)))
    main_fn(list(argv))


def _ensure_geometry(args, logger) -> None:
    """Populate --geometry-dir with export_scene_geometry when it is empty."""
    if glob.glob(os.path.join(args.geometry_dir, "*.npz")):
        logger.info(f"geometry: reusing {args.geometry_dir}")
        return
    from vlnce_torch.scripts.export_scene_geometry import main as export_main

    argv = ["--out-dir", args.geometry_dir]
    if args.connectivity:
        argv += ["--connectivity", args.connectivity]
    if args.habitat_geometry:
        argv += ["--habitat", "--exp-config", args.exp_config]
    _run_script(export_main, "vlnce_torch.scripts.export_scene_geometry", argv, logger)


def _ensure_bank(args, geometry_opts, logger) -> None:
    """Populate --bank-dir with generate_feature_bank when it is empty."""
    if glob.glob(os.path.join(args.bank_dir, "*.npz")):
        logger.info(f"feature bank: reusing {args.bank_dir}")
        return
    from vlnce_torch.scripts.generate_feature_bank import main as gen_main

    argv = ["--exp-config", args.exp_config,
            "--bank-dir", args.bank_dir,
            "--headings", str(args.bank_headings),
            "--spacing", str(args.bank_spacing)]
    if args.connectivity:
        argv += ["--connectivity", args.connectivity]
    argv += [str(o) for o in geometry_opts] + [str(o) for o in (args.opts or [])]
    argv += ["TASK_CONFIG.DATASET.SPLIT", args.split]
    _run_script(gen_main, "vlnce_torch.scripts.generate_feature_bank", argv, logger)


def _check(stats, expected_pairs, tolerance, tag, logger, failures) -> None:
    for name, expected in expected_pairs:
        if expected is None or name not in stats:
            continue
        got = float(stats[name])
        delta = abs(got - expected)
        status = "OK" if delta <= tolerance else "FAIL"
        logger.info(
            f"[{tag}] {name}: got {got:.4f}, expected {expected:.4f}, "
            f"|d|={delta:.4f} [{status}]"
        )
        if delta > tolerance:
            failures.append(f"{tag}:{name}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--exp-config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--split", default="val_unseen")
    parser.add_argument("--expected-spl", type=float, default=None)
    parser.add_argument("--expected-ndtw", type=float, default=None)
    parser.add_argument("--tolerance", type=float, default=0.01,
                        help="max |metric - expected| (1 point = 0.01)")
    parser.add_argument("--resident", action="store_true",
                        help="also run the scan eval on the card "
                             "(geometry import + feature bank + scan eval)")
    parser.add_argument("--geometry-dir", default="",
                        help="scene-geometry npz dir (exported when empty); "
                             "omit to use geometry already configured/synthetic")
    parser.add_argument("--connectivity", default="",
                        help="MP3D connectivity_graphs.pkl for geometry export")
    parser.add_argument("--habitat-geometry", action="store_true",
                        help="sample the navmesh via habitat_sim instead")
    parser.add_argument("--bank-dir", default="",
                        help="feature-bank npz dir (generated when empty); "
                             "omit to scan-eval with live raycast rendering")
    parser.add_argument("--bank-headings", type=int, default=24)
    parser.add_argument("--bank-spacing", type=float, default=2.0)
    parser.add_argument("--resident-tolerance", type=float, default=0.02,
                        help="max |resident metric - host-loop metric|")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)

    import torch

    import vlnce_torch.models.cma_policy  # noqa: F401  (registry population)
    import vlnce_torch.models.seq2seq_policy  # noqa: F401
    import vlnce_torch.models.waypoint_policy  # noqa: F401
    import vlnce_torch.tasks  # noqa: F401
    import vlnce_torch.trainers  # noqa: F401
    from vlnce_torch.config import get_config
    from vlnce_torch.envs import ensure_registered
    from vlnce_torch.envs import rl_envs  # noqa: F401
    from vlnce_torch.registry import registry
    from vlnce_torch.utils.logging import logger

    ensure_registered()

    base_opts = list(args.opts or [])
    geometry_opts = []
    if args.geometry_dir:
        geometry_opts = ["TASK_CONFIG.SIMULATOR.GEOMETRY_DIR", args.geometry_dir]
    eval_opts = base_opts + [
        "EVAL.SPLIT", args.split,
        "EVAL.USE_CKPT_CONFIG", False,
        "EVAL.EPISODE_COUNT", -1,  # the full split: exact-set parity
        "EVAL.SAVE_RESULTS", True,
    ]
    failures: list = []
    expected = (("spl", args.expected_spl), ("ndtw", args.expected_ndtw))

    # ---------------------------------------------------- stage 1: host loop
    if args.resident and args.geometry_dir:
        _ensure_geometry(args, logger)  # the host loop steps the SAME geometry
    config = get_config(args.exp_config, eval_opts + geometry_opts)
    # seeded as run_exp seeds a run: without a checkpoint file both stages
    # (and the bank generator) start from the same seeded weights
    random.seed(config.TASK_CONFIG.SEED)
    np.random.seed(config.TASK_CONFIG.SEED)
    torch.manual_seed(config.TASK_CONFIG.SEED)
    host_stats = _run_eval(config, args.checkpoint, registry)
    if host_stats is None:
        logger.info("eval skipped (stats file already exists) — delete it to rerun")
        return 1
    logger.info("host-loop stats: " + json.dumps(host_stats, indent=2, default=float))
    _check(host_stats, expected, args.tolerance, "host", logger, failures)

    # ------------------------------------------- stage 2: scan eval on the card
    if args.resident:
        bank_opts = []
        if args.bank_dir:
            _ensure_bank(args, geometry_opts, logger)
            bank_opts = ["CUDA.FEATURE_BANK_DIR", args.bank_dir]
        resident_cfg = get_config(
            args.exp_config,
            eval_opts + geometry_opts + bank_opts + [
                "EVAL.ON_DEVICE_SCAN", True,
                # a stats file of its own: stage 1's is not overwritten
                "RESULTS_DIR", os.path.join(config.RESULTS_DIR, "resident"),
            ],
        )
        torch.manual_seed(config.TASK_CONFIG.SEED)
        resident_stats = _run_eval(resident_cfg, args.checkpoint, registry)
        if resident_stats is None:
            logger.info("resident eval skipped (stats exist) — delete to rerun")
            return 1
        logger.info(
            "resident scan-eval stats: "
            + json.dumps(resident_stats, indent=2, default=float)
        )
        _check(resident_stats, expected, args.tolerance, "resident", logger, failures)
        # resident against host: the same checkpoint, episodes and geometry;
        # the loop on the card must agree with the host loop
        host_pairs = tuple(
            (name, float(host_stats[name]))
            for name in ("spl", "ndtw", "success")
            if name in host_stats and name in resident_stats
        )
        _check(resident_stats, host_pairs, args.resident_tolerance,
               "resident-vs-host", logger, failures)

    if failures:
        logger.info(f"PARITY FAILED for: {failures}")
        return 1
    logger.info("PARITY OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
