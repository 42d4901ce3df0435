"""Export real-scene geometry grids for the loops on the card.

Port of scripts/export_scene_geometry.py. Writes `{out_dir}/{scene_stem}.npz`
occupancy-grid twins (the envs/scene_import.py schema, which both packages
read) from the reference's MP3D panorama connectivity graphs
(`--connectivity data/connectivity_graphs.pkl`, reference
habitat_extensions/measures.py:336-337): the walkable corridors around the
nodes and edges are rasterized. Unpickling that file needs networkx.

At run time, point `TASK_CONFIG.SIMULATOR.GEOMETRY_DIR` at `--out-dir`: every
host and card loop then steps the exported geometry, and
`python -m vlnce_torch.scripts.generate_feature_bank` supplies the features
at its graph nodes.

    python -m vlnce_torch.scripts.export_scene_geometry \
        --connectivity data/connectivity_graphs.pkl \
        --out-dir data/scene_geometry [--scenes 17DRP5sb8fy ...]

The JAX script's second source, `--habitat` (the navmesh sampled through
habitat_sim), waits for the port of envs/habitat_adapter.py and raises.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--connectivity", default="", help="MP3D connectivity_graphs.pkl to rasterize")
    ap.add_argument("--habitat", action="store_true", help="sample the navmesh through habitat_sim (not ported)")
    ap.add_argument("--scenes", nargs="*", default=None, help="scene stems to export (default: all in the source)")
    ap.add_argument("--corridor-radius", type=float, default=None,
                    help="graph rasterization corridor half-width in meters")
    args = ap.parse_args(argv)
    if not args.connectivity and not args.habitat:
        ap.error("need --connectivity and/or --habitat")
    if args.habitat:
        raise NotImplementedError(
            "--habitat needs envs/habitat_adapter.py, which vlnce_torch has not ported yet "
            "(ROADMAP.md section A, 'Left by the serving slice'); use --connectivity"
        )

    from vlnce_torch.envs import scene_import as si
    from vlnce_torch.utils.logging import logger

    os.makedirs(args.out_dir, exist_ok=True)
    kw = {} if args.corridor_radius is None else {"corridor_radius": args.corridor_radius}
    exported = si.import_connectivity_graphs(args.connectivity, scene_ids=args.scenes, register=False, **kw)
    logger.info(f"rasterized {len(exported)} scenes from {args.connectivity}")

    for stem, scene in exported.items():
        out = os.path.join(args.out_dir, f"{si._scene_stem(stem)}.npz")
        si.save_scene_geometry(out, scene)
        logger.info(f"{stem}: {scene.n}x{scene.n} cells @ origin {scene.origin} -> {out}")
    logger.info(f"{len(exported)} scenes exported; set TASK_CONFIG.SIMULATOR.GEOMETRY_DIR={args.out_dir} to use them")


if __name__ == "__main__":
    main()
