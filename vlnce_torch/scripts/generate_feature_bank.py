"""Generate per-scene visual feature banks for the loops on the card
(data/feature_bank.py).

Port of scripts/generate_feature_bank.py. For every scene of the configured
dataset split it renders the grid world on the policy's device at each
(node, heading bin) pose, runs the policy's frozen encoders once per pose,
and writes `{bank_dir}/{scene_stem}.npz` in the bank schema, which both
packages read. At run time the scan eval and DAgger collection with
`CUDA.FEATURE_BANK_DIR` look the features up in place of rendering.

Nodes are the scene's MP3D connectivity-graph nodes (`--connectivity`, the
reference's pickle, keyed by scene id or stem; unpickling it needs
networkx), else a lattice over the navigable cells at `--spacing` meters.
Imported geometry (`TASK_CONFIG.SIMULATOR.GEOMETRY_DIR` or
`CONNECTIVITY_GRAPHS`) is installed first, so the banks of exported scenes
are rendered on their own grids. The policy is the trainer's, from
`IL.ckpt_to_load` with `IL.load_from_ckpt True` (a checkpoint of either
package), else seeded from `TASK_CONFIG.SEED` as `run.run_exp` seeds.

    python -m vlnce_torch.scripts.generate_feature_bank \
        --exp-config vlnce_torch/config/experiments/r2r_baselines/cma_pm_da_aug_tune.yaml \
        --bank-dir data/feature_banks/r2r --headings 24 --spacing 2.0 [opts ...]
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch


def graph_nodes(graph) -> np.ndarray:
    """Connectivity-graph nodes -> [M, 2] world (x, z)."""
    from vlnce_torch.utils.nav_graph import _node_position

    return np.asarray([[_node_position(graph, n)[0], _node_position(graph, n)[-1]] for n in graph.nodes], np.float32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--exp-config", required=True)
    ap.add_argument("--bank-dir", required=True)
    ap.add_argument("--headings", type=int, default=24, help="heading bins (24 = one per 15-degree R2R turn)")
    ap.add_argument("--spacing", type=float, default=2.0,
                    help="lattice node spacing in meters (no connectivity graph)")
    ap.add_argument("--connectivity", default="", help="MP3D connectivity_graphs.pkl (optional)")
    ap.add_argument("--chunk", type=int, default=256, help="poses encoded per forward")
    ap.add_argument("opts", nargs="*", default=[])
    args = ap.parse_args(argv)

    import vlnce_torch.models.cma_policy  # noqa: F401  (registry population)
    import vlnce_torch.models.seq2seq_policy  # noqa: F401
    import vlnce_torch.tasks  # noqa: F401
    import vlnce_torch.trainers  # noqa: F401
    from vlnce_torch.config import get_config
    from vlnce_torch.data.feature_bank import encode_scene_bank, lattice_nodes, save_scene_bank
    from vlnce_torch.envs import ensure_registered
    from vlnce_torch.envs import rl_envs  # noqa: F401
    from vlnce_torch.envs.device_sim import camera_specs_from_config
    from vlnce_torch.envs.gridworld import get_scene
    from vlnce_torch.envs.scene_import import _scene_stem, apply_scene_geometry
    from vlnce_torch.registry import registry
    from vlnce_torch.tasks.datasets import make_dataset
    from vlnce_torch.utils.logging import logger
    from vlnce_torch.utils.nav_graph import load_connectivity_graphs

    ensure_registered()
    cfg = get_config(args.exp_config, opts=list(args.opts) or None)
    # seeded as run_exp seeds a run, so that seeded weights are the same draw
    random.seed(cfg.TASK_CONFIG.SEED)
    np.random.seed(cfg.TASK_CONFIG.SEED)
    torch.manual_seed(cfg.TASK_CONFIG.SEED)
    task_cfg = cfg.TASK_CONFIG
    if task_cfg.SIMULATOR.TYPE != "GridWorldSim-v0":
        raise SystemExit(
            "this generator renders through the grid world on the card; for real MP3D scenes run it where "
            "habitat_sim is installed (envs/habitat_adapter.py renders the poses through get_observations_at, "
            f"the same encoder path). SIMULATOR.TYPE={task_cfg.SIMULATOR.TYPE}"
        )

    apply_scene_geometry(task_cfg.SIMULATOR)  # real-scene grids, if configured
    dataset = make_dataset(task_cfg.DATASET.TYPE, task_cfg.DATASET)
    scene_ids = sorted({ep.scene_id for ep in dataset.episodes})
    logger.info(f"{len(scene_ids)} scenes, {args.headings} heading bins")

    graphs = load_connectivity_graphs(args.connectivity) if args.connectivity else None
    specs = camera_specs_from_config(task_cfg.SIMULATOR)
    # the trainer supplies the spaces, the transforms and the (optionally
    # checkpoint-loaded) policy whose frozen encoders define the features
    trainer = registry.get_trainer(cfg.TRAINER_NAME)(cfg)
    obs_space, act_space = trainer._get_spaces(cfg)
    trainer._initialize_policy(cfg, load_from_ckpt=bool(cfg.IL.load_from_ckpt),
                               observation_space=obs_space, action_space=act_space)
    policy, transforms = trainer.policy, trainer.obs_transforms

    os.makedirs(args.bank_dir, exist_ok=True)
    H = args.headings
    headings = (2.0 * np.pi / H) * np.arange(H, dtype=np.float32)
    for scene_id in scene_ids:
        scene = get_scene(scene_id)
        # the reference's connectivity_graphs.pkl keys by scene stem
        # ('17DRP5sb8fy'); episode scene_ids carry the relative path
        graph = None
        if graphs is not None:
            graph = graphs.get(scene_id) or graphs.get(_scene_stem(scene_id))
        nodes = graph_nodes(graph) if graph is not None else lattice_nodes(scene, args.spacing)
        rgb_all, depth_all, rgb_shape, depth_shape = encode_scene_bank(
            policy, transforms, specs, scene, nodes, headings, chunk=args.chunk)
        out = os.path.join(args.bank_dir, f"{_scene_stem(scene_id)}.npz")
        save_scene_bank(out, nodes, rgb_all, depth_all, rgb_shape, depth_shape)
        logger.info(f"{scene_id}: {nodes.shape[0]} nodes -> {out} "
                    f"({(rgb_all.nbytes + depth_all.nbytes) / 2**21:.1f} MiB f16)")


if __name__ == "__main__":
    main()
