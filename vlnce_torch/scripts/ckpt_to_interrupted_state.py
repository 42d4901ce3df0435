"""Turn a training checkpoint into a requeue interrupted-state file.

Port of scripts/ckpt_to_interrupted_state.py (reference
scripts/ckpt_to_interrupted_state.py:1-43): a DD-PPO run restarts from any
checkpoint through `RL.DDPPO.start_from_requeue` and `RL.DDPPO.requeue_path`.
It reads a checkpoint of either package (`utils/checkpoints.load_checkpoint`)
and writes the port's format; a JAX file's Adam moments are kept by name and
installed at the restart by `parallel/optim.load_optim_state`.

    python -m vlnce_torch.scripts.ckpt_to_interrupted_state --ckpt ckpt.5.ckpt \
        --out data/interrupted_state.ckpt [--update 1250]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--out", default="data/interrupted_state.ckpt")
    parser.add_argument("--update", type=int, default=0, help="update counter to resume from")
    args = parser.parse_args(argv)

    from vlnce_torch.utils.checkpoints import config_from_checkpoint, load_checkpoint, save_checkpoint

    ckpt = load_checkpoint(args.ckpt)
    extra = dict(ckpt.get("extra_state") or {})
    extra.setdefault("update", args.update)
    extra.setdefault("count_steps", 0)
    save_checkpoint(
        args.out, ckpt["state_dict"], config=config_from_checkpoint(ckpt),
        optim_state=ckpt.get("optim_state"), extra_state=extra,
    )
    print(f"wrote interrupted state to {args.out} (resume update {extra['update']})")


if __name__ == "__main__":
    main()
