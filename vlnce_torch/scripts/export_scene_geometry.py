"""Export real-scene geometry grids for the loops on the card.

Port of scripts/export_scene_geometry.py. Writes `{out_dir}/{scene_stem}.npz`
occupancy-grid twins (the envs/scene_import.py schema, which both packages
read) from either source:

- `--connectivity data/connectivity_graphs.pkl`, the reference's MP3D
  panorama connectivity graphs (reference habitat_extensions/measures.py:
  336-337): the walkable corridors around the nodes and edges are
  rasterized. Unpickling that file needs networkx.
- `--habitat --exp-config <task yaml>`: the navmesh of each of the
  dataset's scenes, sampled through habitat_sim (`envs/habitat_adapter.py`,
  `pathfinder.is_navigable` per cell). Needs habitat_sim and the scenes.

At run time, point `TASK_CONFIG.SIMULATOR.GEOMETRY_DIR` at `--out-dir`: every
host and card loop then steps the exported geometry, and
`python -m vlnce_torch.scripts.generate_feature_bank` supplies the features
at its graph nodes.

    python -m vlnce_torch.scripts.export_scene_geometry \
        --connectivity data/connectivity_graphs.pkl \
        --out-dir data/scene_geometry [--scenes 17DRP5sb8fy ...]
    python -m vlnce_torch.scripts.export_scene_geometry --habitat \
        --exp-config vlnce_torch/config/experiments/r2r_baselines/cma_pm_da_aug_tune.yaml \
        --out-dir data/scene_geometry
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--connectivity", default="", help="MP3D connectivity_graphs.pkl to rasterize")
    ap.add_argument("--habitat", action="store_true", help="sample the navmesh through habitat_sim (needs assets)")
    ap.add_argument("--exp-config", default="",
                    help="experiment yaml naming the dataset (scene selection; required with --habitat)")
    ap.add_argument("--scenes", nargs="*", default=None, help="scene stems to export (default: all in the source)")
    ap.add_argument("--corridor-radius", type=float, default=None,
                    help="graph rasterization corridor half-width in meters")
    ap.add_argument("opts", nargs="*", default=[])
    args = ap.parse_args(argv)
    if not args.connectivity and not args.habitat:
        ap.error("need --connectivity and/or --habitat")

    from vlnce_torch.envs import scene_import as si
    from vlnce_torch.utils.logging import logger

    os.makedirs(args.out_dir, exist_ok=True)
    exported = {}
    if args.connectivity:
        kw = {} if args.corridor_radius is None else {"corridor_radius": args.corridor_radius}
        scenes = si.import_connectivity_graphs(args.connectivity, scene_ids=args.scenes, register=False, **kw)
        exported.update(scenes)
        logger.info(f"rasterized {len(scenes)} scenes from {args.connectivity}")

    if args.habitat:
        if not args.exp_config:
            raise SystemExit("--habitat requires --exp-config to name the dataset")
        try:
            import habitat_sim  # noqa: F401
        except ImportError:
            raise SystemExit("--habitat requires habitat_sim; without it use --connectivity instead")
        from vlnce_torch.config import get_config
        # the adapter module (not the class) is imported after the check, so
        # a test's stand-in habitat_sim can reload it underneath
        from vlnce_torch.envs import habitat_adapter
        from vlnce_torch.tasks.datasets import make_dataset

        task_cfg = get_config(args.exp_config, opts=list(args.opts) or None).TASK_CONFIG
        dataset = make_dataset(task_cfg.DATASET.TYPE, task_cfg.DATASET)
        scene_ids = sorted({ep.scene_id for ep in dataset.episodes})
        if args.scenes:
            want = set(args.scenes)
            scene_ids = [s for s in scene_ids if si._scene_stem(s) in want]
        sim = habitat_adapter.HabitatSimAdapter(task_cfg.SIMULATOR)
        for scene_id in scene_ids:
            sim.reconfigure(scene_id)
            stem = si._scene_stem(scene_id)
            exported[stem] = si.scene_from_habitat(stem, sim._sim)
            logger.info(f"sampled navmesh for {stem}")
        sim.close()

    for stem, scene in exported.items():
        out = os.path.join(args.out_dir, f"{si._scene_stem(stem)}.npz")
        si.save_scene_geometry(out, scene)
        logger.info(f"{stem}: {scene.n}x{scene.n} cells @ origin {scene.origin} -> {out}")
    logger.info(f"{len(exported)} scenes exported; set TASK_CONFIG.SIMULATOR.GEOMETRY_DIR={args.out_dir} to use them")


if __name__ == "__main__":
    main()
