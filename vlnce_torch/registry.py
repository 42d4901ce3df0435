"""The port's plugin registry.

A copy of the JAX package's namespaced registry, kept separate so that a
policy registered here never replaces the reference's entry of the same name.
Components self-register via decorators at import time; lookups are by
(namespace, name). Registered so far: policies, observation transformers,
trainers, envs, datasets, sensors, measures, task actions, simulators and
the nonlearning agents.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Optional, Type


class Registry:
    """Namespaced name -> class mapping with decorator-based registration."""

    def __init__(self) -> None:
        self._map: Dict[str, Dict[str, Any]] = collections.defaultdict(dict)

    def _register(self, namespace: str, to_register: Optional[Any], name: Optional[str]) -> Callable:
        def wrap(cls):
            self._map[namespace][cls.__name__ if name is None else name] = cls
            return cls

        if to_register is None:
            return wrap
        return wrap(to_register)

    def get(self, namespace: str, name: str) -> Any:
        try:
            return self._map[namespace][name]
        except KeyError:
            known = sorted(self._map[namespace])
            raise KeyError(f"'{name}' not registered under '{namespace}'. Known: {known}") from None

    def register_trainer(self, to_register=None, *, name: Optional[str] = None):
        return self._register("trainer", to_register, name)

    def register_policy(self, to_register=None, *, name: Optional[str] = None):
        return self._register("policy", to_register, name)

    def register_env(self, to_register=None, *, name: Optional[str] = None):
        return self._register("env", to_register, name)

    def register_dataset(self, to_register=None, *, name: Optional[str] = None):
        return self._register("dataset", to_register, name)

    def register_sensor(self, to_register=None, *, name: Optional[str] = None):
        return self._register("sensor", to_register, name)

    def register_measure(self, to_register=None, *, name: Optional[str] = None):
        return self._register("measure", to_register, name)

    def register_task_action(self, to_register=None, *, name: Optional[str] = None):
        return self._register("task_action", to_register, name)

    def register_obs_transformer(self, to_register=None, *, name: Optional[str] = None):
        return self._register("obs_transformer", to_register, name)

    def register_simulator(self, to_register=None, *, name: Optional[str] = None):
        return self._register("simulator", to_register, name)

    def register_agent(self, to_register=None, *, name: Optional[str] = None):
        return self._register("agent", to_register, name)

    def get_trainer(self, name: str) -> Type:
        return self.get("trainer", name)

    def get_policy(self, name: str) -> Type:
        return self.get("policy", name)

    def get_env(self, name: str) -> Type:
        return self.get("env", name)

    def get_dataset(self, name: str) -> Type:
        return self.get("dataset", name)

    def get_sensor(self, name: str) -> Type:
        return self.get("sensor", name)

    def get_measure(self, name: str) -> Type:
        return self.get("measure", name)

    def get_task_action(self, name: str) -> Type:
        return self.get("task_action", name)

    def get_obs_transformer(self, name: str) -> Type:
        return self.get("obs_transformer", name)

    def get_simulator(self, name: str) -> Type:
        return self.get("simulator", name)

    def get_agent(self, name: str) -> Type:
        return self.get("agent", name)


registry = Registry()
