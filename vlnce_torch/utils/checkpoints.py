"""Checkpoint save/load.

Format: one `torch.save` file holding

    {"state_dict": {reference key: tensor on the CPU}, "config_yaml": str,
     "optim_state": optimizer.state_dict() on the CPU, "extra_state": {...}}

with the config dumped as YAML: the config-in-checkpoint behaviour that eval
and inference rely on (EVAL.USE_CKPT_CONFIG, reference
base_il_trainer.py:117-132,235-237,439-445). Files are written to a temp name
and renamed, so the eval-many poller (`poll_checkpoint_folder`) never sees a
torn checkpoint.

`load_checkpoint` also reads the JAX package's files, which are flax msgpack
under the same suffixes (vlnce_tpu/utils/checkpoints.py). It tells the two
formats apart by their first bytes, not by their suffix: a `torch.save`
file is a zip archive. A JAX file is decoded by `utils/msgpack_reader` and
returned in this package's shape: its params carried across by
`models/convert.state_dict_from_jax_params`, and optax's Adam moments, which
have the params' tree, carried through the same converter (see
`_optax_adam_state`; `parallel/optim.load_optim_state` installs them).

The snapshot to host memory is synchronous and copies (the next train step
changes the parameters in place). With `async_write=True`
(CUDA.ASYNC_CHECKPOINT) `torch.save` and the rename run on a background
thread while training goes on: one write in flight at a time; an error
surfaces on the next save or at `wait_for_pending()`, which trainers call
when their train loop ends (an atexit hook covers aborts).
"""

from __future__ import annotations

import atexit
import os
import threading
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from vlnce_torch.config.node import Config
from vlnce_torch.models.convert import state_dict_from_jax_params
from vlnce_torch.parallel.distributed import world_rank
from vlnce_torch.utils.msgpack_reader import unpackb

CHECKPOINT_SUFFIXES = (".ckpt", ".pth", ".msgpack")
_ZIP_MAGIC = b"PK\x03\x04"  # torch.save writes a zip archive


def _host_snapshot(obj):
    """A copy of a nest of dicts, lists and tensors with every tensor in host
    memory. Tensors that are on the CPU already are cloned: an aliased
    snapshot handed to the writer thread would race the live training state."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        return t.clone() if t.device.type == "cpu" else t.cpu()
    if isinstance(obj, Mapping):
        return {k: _host_snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_snapshot(v) for v in obj)
    return obj


def _write_atomic(path: str, payload: Dict[str, Any]) -> None:
    # unique temp name: two writers of one path must not rename each other's
    # half-written file away
    tmp = f"{path}.tmp.{os.getpid()}-{threading.get_ident()}"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic: pollers never see a torn file


class _AsyncWriter:
    """At most one checkpoint write in flight; exceptions are re-raised on
    the next submit/wait so a failing disk cannot silently drop epochs."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def _run(self, path: str, payload: Dict[str, Any]) -> None:
        try:
            _write_atomic(path, payload)
        except BaseException as e:  # surfaced on the next submit/wait
            self._exc = e

    def submit(self, path: str, payload: Dict[str, Any]) -> None:
        self.wait()
        self._thread = threading.Thread(target=self._run, args=(path, payload), name="ckpt-writer", daemon=False)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError("async checkpoint write failed") from exc


_WRITER = _AsyncWriter()
atexit.register(_WRITER.wait)


def wait_for_pending() -> None:
    """Block until any in-flight async checkpoint write completes (raises if
    it failed). Trainers call this when their train loop ends, so a caller
    that loads the last checkpoint right after train() can never race the
    writer."""
    _WRITER.wait()


def save_checkpoint(
    path: str,
    state_dict: Mapping[str, torch.Tensor],
    config=None,
    optim_state: Optional[Dict[str, Any]] = None,
    extra_state: Optional[Dict[str, Any]] = None,
    async_write: bool = False,
    all_ranks: bool = False,
) -> None:
    """Write a checkpoint (on a background thread with `async_write`). Under
    several ranks only rank 0 writes (the weights are replicated), unless
    `all_ranks`: a node-local path, such as DD-PPO's requeue state, that
    every rank must find again on restart."""
    if not all_ranks and world_rank() != 0:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload: Dict[str, Any] = {"state_dict": _host_snapshot(state_dict)}
    if optim_state is not None:
        payload["optim_state"] = _host_snapshot(optim_state)
    if extra_state is not None:
        payload["extra_state"] = extra_state
    if config is not None:
        payload["config_yaml"] = config.dump()
    if async_write:
        _WRITER.submit(path, payload)
    else:
        _WRITER.wait()  # keep ordering if a prior async write is in flight
        _write_atomic(path, payload)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint's dict, tensors on the CPU, from a file of either
    package. Of a `torch.save` file only tensors and plain Python values are
    unpickled; anything else is read as the JAX package's flax msgpack."""
    with open(path, "rb") as f:
        if f.read(len(_ZIP_MAGIC)) == _ZIP_MAGIC:
            f.seek(0)
            return torch.load(f, map_location="cpu", weights_only=True)
        f.seek(0)
        payload = unpackb(f.read())
    return _from_jax_payload(payload, path)


def _policy_name(payload: Dict[str, Any]) -> str:
    """MODEL.policy_name of the file's config; the config default
    (CMAPolicy) for a file that holds none."""
    if "config_yaml" not in payload:
        return "CMAPolicy"
    import yaml

    model = (yaml.safe_load(payload["config_yaml"]) or {}).get("MODEL") or {}
    return str(model.get("policy_name", "CMAPolicy"))


def _from_jax_payload(payload: Dict[str, Any], path: str) -> Dict[str, Any]:
    if not isinstance(payload, dict) or "state_dict" not in payload:
        raise ValueError(f"{path}: neither a torch.save file nor a JAX checkpoint (no state_dict)")
    name = _policy_name(payload)
    out: Dict[str, Any] = {"state_dict": state_dict_from_jax_params(payload["state_dict"], name)}
    for key in ("config_yaml", "extra_state"):
        if key in payload:
            out[key] = payload[key]
    if payload.get("optim_state") is not None:
        out["optim_state"] = _optax_adam_state(payload["optim_state"], payload["state_dict"], name, path)
    return out


def _adam_nodes(node, found):
    """Every map of the optax state tree with Adam's `count`, `mu` and `nu`."""
    if isinstance(node, dict):
        if {"count", "mu", "nu"} <= set(node):
            found.append(node)
        else:
            for v in node.values():
                _adam_nodes(v, found)
    return found


def _fill_masked(moments, params, present: bool):
    """The moment tree with optax.masked's placeholders (`{}` where a leaf is
    frozen) filled with zeros of the param's shape; with `present`, a tree
    of ones where the moment exists and zeros where it is a placeholder."""
    if isinstance(params, dict):
        return {k: _fill_masked(moments.get(k, {}) if isinstance(moments, dict) else moments, v, present)
                for k, v in params.items()}
    held = not isinstance(moments, dict)
    if present:
        return np.full(np.shape(params), float(held), np.float32)
    return np.asarray(moments, np.float32) if held else np.zeros(np.shape(params), np.float32)


def _optax_adam_state(optim_state, params, policy_name: str, path: str) -> Dict[str, Any]:
    """optax's Adam state -> {"optax_adam": {"step", "exp_avg", "exp_avg_sq",
    "moment_keys"}}, the moments under this package's state_dict keys and
    layouts. `moment_keys` are the keys whose moments the file holds (optax
    holds none for a masked, frozen leaf)."""
    nodes = _adam_nodes(optim_state, [])
    if len(nodes) != 1:
        raise ValueError(
            f"{path}: the optimizer state holds {len(nodes)} Adam states (count, mu, nu), not one, so "
            f"Adam's moments cannot be carried into torch.optim.Adam"
        )
    adam = nodes[0]
    present = state_dict_from_jax_params(_fill_masked(adam["mu"], params, True), policy_name)
    return {"optax_adam": {
        "step": int(np.asarray(adam["count"])),
        "exp_avg": state_dict_from_jax_params(_fill_masked(adam["mu"], params, False), policy_name),
        "exp_avg_sq": state_dict_from_jax_params(_fill_masked(adam["nu"], params, False), policy_name),
        "moment_keys": sorted(k for k, v in present.items() if bool(v.any())),
    }}


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
