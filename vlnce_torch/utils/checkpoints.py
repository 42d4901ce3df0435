"""Checkpoint save/load.

Format: one `torch.save` file holding

    {"state_dict": {reference key: tensor on the CPU}, "config_yaml": str,
     "extra_state": {...}}

with the config dumped as YAML: the config-in-checkpoint behaviour that eval
and inference rely on (EVAL.USE_CKPT_CONFIG, reference
base_il_trainer.py:117-132,235-237,439-445). Files are written to a temp name
and renamed, so the eval-many poller (`poll_checkpoint_folder`) never sees a
torn checkpoint. Optimizer state and the asynchronous writer of the JAX
package come with the training slice. The JAX package's msgpack files cannot
be read here (that takes flax); weights cross between the packages through
`models/convert.state_dict_from_jax_params`.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Mapping, Optional

import torch

from vlnce_torch.config.node import Config

CHECKPOINT_SUFFIXES = (".ckpt", ".pth")


def save_checkpoint(
    path: str,
    state_dict: Mapping[str, torch.Tensor],
    config=None,
    extra_state: Optional[Dict[str, Any]] = None,
) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload: Dict[str, Any] = {"state_dict": {k: v.detach().cpu() for k, v in state_dict.items()}}
    if extra_state is not None:
        payload["extra_state"] = extra_state
    if config is not None:
        payload["config_yaml"] = config.dump()
    # unique temp name: two writers of one path must not rename each other's
    # half-written file away
    tmp = f"{path}.tmp.{os.getpid()}-{threading.get_ident()}"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic: pollers never see a torn file


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint's dict, tensors on the CPU. Only tensors and plain
    Python values are unpickled."""
    return torch.load(path, map_location="cpu", weights_only=True)


def config_from_checkpoint(ckpt: Dict[str, Any]) -> Optional[Config]:
    if "config_yaml" not in ckpt:
        return None
    import yaml

    return Config(yaml.safe_load(ckpt["config_yaml"]))


def poll_checkpoint_folder(checkpoint_dir: str, previous_index: int) -> Optional[str]:
    """Next unevaluated checkpoint in a directory, ordered by mtime
    (habitat poll_checkpoint_folder equivalent; reference README.md:251
    eval-many behavior)."""
    if not os.path.isdir(checkpoint_dir):
        return checkpoint_dir if previous_index < 0 else None
    models = [
        os.path.join(checkpoint_dir, f)
        for f in os.listdir(checkpoint_dir)
        if f.endswith(CHECKPOINT_SUFFIXES)
    ]
    models.sort(key=os.path.getmtime)
    ind = previous_index + 1
    if ind < len(models):
        return models[ind]
    return None
