"""The port's plugin registry.

A copy of the JAX package's namespaced registry, kept separate so that a
policy registered here never replaces the reference's entry of the same name.
Components self-register via decorators at import time; lookups are by
(namespace, name). This slice registers policies and observation transformers.
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

    def register_policy(self, to_register=None, *, name: Optional[str] = None):
        return self._register("policy", to_register, name)

    def register_obs_transformer(self, to_register=None, *, name: Optional[str] = None):
        return self._register("obs_transformer", to_register, name)

    def get_policy(self, name: str) -> Type:
        return self.get("policy", name)

    def get_obs_transformer(self, name: str) -> Type:
        return self.get("obs_transformer", name)


registry = Registry()
