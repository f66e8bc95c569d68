"""Pure-python config system compatible with the reference's MMEngine surface.

The reference drives everything from python config files with ``_base_`` list
inheritance and dotted ``--cfg-option`` overrides (README.md:57-70,
configs/patchrefiner_zoedepth/pr_u4k.py:1-5). MMEngine is not a dependency
here; this module re-implements the subset those configs use:

* python config files executed in an isolated namespace,
* ``_base_`` relative-path inheritance with recursive dict merge
  (``_delete_=True`` resets a node),
* dotted-path CLI overrides with literal-eval value parsing,
* attribute-style access on nested dicts (``cfg.model.config.max_depth``).
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict(
            {copy.deepcopy(k, memo): copy.deepcopy(v, memo) for k, v in self.items()}
        )

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict({k: ConfigDict._wrap(v) for k, v in value.items()})
        if isinstance(value, ConfigDict):
            return ConfigDict({k: ConfigDict._wrap(v) for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            wrapped = [ConfigDict._wrap(v) for v in value]
            return type(value)(wrapped) if isinstance(value, tuple) else wrapped
        return value

    def to_dict(self) -> dict:
        def _unwrap(v):
            if isinstance(v, dict):
                return {k: _unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [_unwrap(x) for x in v]
            return v

        return _unwrap(self)

    def get_nested(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def _merge_dict(base: dict, override: dict) -> dict:
    """MMEngine-style recursive merge: override wins, dicts merge recursively,
    an override node containing ``_delete_=True`` replaces the base node."""
    merged = dict(base)
    for key, value in override.items():
        if (
            isinstance(value, dict)
            and isinstance(merged.get(key), dict)
            and not value.pop("_delete_", False)
        ):
            merged[key] = _merge_dict(merged[key], value)
        else:
            if isinstance(value, dict):
                value = {k: v for k, v in value.items() if k != "_delete_"}
            merged[key] = value
    return merged


def _exec_config_file(path: str) -> Dict[str, Any]:
    path = os.path.abspath(path)
    with open(path, "r") as f:
        source = f.read()
    namespace: Dict[str, Any] = {"__file__": path}
    exec(compile(source, path, "exec"), namespace)
    return {
        k: v
        for k, v in namespace.items()
        if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))
    }


def _load_with_bases(path: str) -> Dict[str, Any]:
    raw = _exec_config_file(path)
    bases: List[str] = raw.pop("_base_", []) or []
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    cfg_dir = os.path.dirname(os.path.abspath(path))
    for base_rel in bases:
        base_cfg = _load_with_bases(os.path.join(cfg_dir, base_rel))
        merged = _merge_dict(merged, base_cfg)
    return _merge_dict(merged, raw)


def _parse_option_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        lowered = text.lower()
        if lowered == "true":
            return True
        if lowered == "false":
            return False
        if lowered in ("none", "null"):
            return None
        return text


class Config(ConfigDict):
    """Top-level config object.

    Use :meth:`fromfile` to parse a python config file (with ``_base_``
    support) and :meth:`merge_from_options` for ``--cfg-option`` overrides.
    """

    @classmethod
    def fromfile(cls, path: str) -> "Config":
        data = _load_with_bases(path)
        cfg = cls(ConfigDict._wrap(data))
        dict.__setitem__(cfg, "_filename_", os.path.abspath(path))
        return cfg

    @classmethod
    def fromdict(cls, data: dict) -> "Config":
        return cls(ConfigDict._wrap(data))

    def merge_from_options(self, options: Dict[str, Any] | List[str] | None) -> "Config":
        """Apply dotted-path overrides: ``{'model.config.max_depth': 80}`` or
        a list of ``'key=value'`` strings (values parsed as python literals)."""
        if not options:
            return self
        if isinstance(options, (list, tuple)):
            parsed = {}
            for item in options:
                key, _, value = item.partition("=")
                parsed[key.strip()] = _parse_option_value(value.strip())
            options = parsed
        for dotted, value in options.items():
            node: dict = self
            parts = dotted.split(".")
            for part in parts[:-1]:
                nxt = node.get(part)
                if not isinstance(nxt, dict):
                    nxt = ConfigDict()
                    node[part] = nxt
                node = nxt
            node[parts[-1]] = ConfigDict._wrap(value)
        return self
