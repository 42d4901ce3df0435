"""Environment layer. Submodules register simulators/envs on import.

Imports are lazy to keep `vlnce_torch.envs.sim` importable from the task layer
without a cycle; accessing Env (or calling ensure_registered) pulls in the
concrete simulator/env registrations.
"""

__all__ = ["Env", "ensure_registered"]


def ensure_registered() -> None:
    from vlnce_torch.envs import gridworld, replay_sim  # noqa: F401


def __getattr__(name):
    if name == "Env":
        ensure_registered()
        from vlnce_torch.envs.env import Env

        return Env
    raise AttributeError(name)
