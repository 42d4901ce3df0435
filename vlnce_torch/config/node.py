"""Minimal YACS-compatible config tree (the port's own copy).

Attribute access, freeze/defrost, clone, YAML merge, dotted-key list merge
(CLI opts) and dump, with yacs semantics where it matters: merging an unknown
key raises; type coercion follows the existing value's type; `None` values may
be replaced by anything. PyYAML is imported only by the functions that parse
or write YAML, so building a config from defaults and opts needs no PyYAML.
"""

from __future__ import annotations

import copy
import io
from typing import Any, Dict, List


class Config(dict):
    """A dict subclass with attribute access and immutability toggling."""

    IMMUTABLE_KEY = "__immutable__"

    def __init__(self, init_dict: Dict = None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, Config.IMMUTABLE_KEY, False)
        for k, v in init_dict.items():
            if isinstance(v, dict):
                v = Config(v)
            dict.__setitem__(self, k, v)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no attribute '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, Config.IMMUTABLE_KEY):
            raise AttributeError(f"Attempted to set '{name}' on an immutable Config; call defrost() first")
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
        dict.__setitem__(self, name, value)

    def __setitem__(self, name: str, value: Any) -> None:
        self.__setattr__(name, value)

    def __deepcopy__(self, memo):
        out = Config()
        for k, v in self.items():
            dict.__setitem__(out, k, copy.deepcopy(v, memo))
        object.__setattr__(out, Config.IMMUTABLE_KEY, False)
        return out

    # -- immutability -------------------------------------------------------
    def is_frozen(self) -> bool:
        return object.__getattribute__(self, Config.IMMUTABLE_KEY)

    def freeze(self) -> "Config":
        self._set_immutable(True)
        return self

    def defrost(self) -> "Config":
        self._set_immutable(False)
        return self

    def _set_immutable(self, value: bool) -> None:
        object.__setattr__(self, Config.IMMUTABLE_KEY, value)
        for v in self.values():
            if isinstance(v, Config):
                v._set_immutable(value)

    def clone(self) -> "Config":
        return copy.deepcopy(self)

    # -- merging ------------------------------------------------------------
    def merge_from_other_cfg(self, other: "Config", allow_new_keys: bool = False) -> None:
        self._merge(other, allow_new_keys=allow_new_keys, path="")

    def _merge(self, other: Dict, allow_new_keys: bool, path: str) -> None:
        for k, v in other.items():
            full = f"{path}.{k}" if path else k
            if k not in self:
                if not allow_new_keys:
                    raise KeyError(f"Non-existent config key: {full}")
                if isinstance(v, dict) and not isinstance(v, Config):
                    v = Config(v)
                dict.__setitem__(self, k, copy.deepcopy(v))
                continue
            cur = self[k]
            if isinstance(cur, Config):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot merge non-dict into Config subtree at {full}")
                cur._merge(v, allow_new_keys, full)
            else:
                dict.__setitem__(self, k, _coerce(v, cur, full))

    def merge_from_file(self, path: str, allow_new_keys: bool = False) -> None:
        import yaml

        with open(path, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded:
            self._merge(loaded, allow_new_keys=allow_new_keys, path="")

    def merge_from_list(self, opts: List[Any]) -> None:
        """Merge from ["KEY.SUBKEY", value, ...] pairs (CLI opts). String
        values are parsed as YAML literals; other values are taken as given."""
        if len(opts) % 2 != 0:
            raise ValueError(f"opts must be key/value pairs, got odd length {len(opts)}: {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], Config):
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            if isinstance(value, str):
                value = _parse_literal(value)
            dict.__setitem__(node, leaf, _coerce(value, node[leaf], key))

    # -- io ------------------------------------------------------------------
    def to_dict(self) -> Dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, Config) else (list(v) if isinstance(v, tuple) else v)
        return out

    def dump(self) -> str:
        import yaml

        stream = io.StringIO()
        yaml.safe_dump(self.to_dict(), stream, default_flow_style=False, sort_keys=True)
        return stream.getvalue()

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"


def _parse_literal(value: str) -> Any:
    """Parse a CLI string value into a python literal via YAML rules.

    YAML 1.1 doesn't treat '1e-3' as a float (needs '1.0e-3'); try numeric
    parsing first so scientific notation works on the command line."""
    import yaml

    try:
        parsed = yaml.safe_load(value)
    except yaml.YAMLError:
        return value
    if isinstance(parsed, str):
        try:
            return float(parsed) if any(c in parsed for c in ".eE") and parsed[0].isdigit() else parsed
        except ValueError:
            return parsed
    return parsed


def _coerce(value: Any, existing: Any, key: str) -> Any:
    """Coerce a merged value toward the existing value's type (yacs rules)."""
    if isinstance(value, dict):
        raise TypeError(f"Cannot replace scalar with dict at {key}")
    if existing is None or value is None:
        return copy.deepcopy(value)
    et, vt = type(existing), type(value)
    if et is vt:
        return copy.deepcopy(value)
    # allowed casts: int->float, tuple<->list, bool from 0/1
    if et is float and vt is int:
        return float(value)
    if et is tuple and vt is list:
        return tuple(value)
    if et is list and vt is tuple:
        return list(value)
    if et is bool and vt is int and value in (0, 1):
        return bool(value)
    raise TypeError(f"Type mismatch merging {key}: cannot replace {et.__name__} with {vt.__name__} ({value!r})")


CN = Config
