"""Name -> class registries with NAME-keyed construction
(``geot_tpu/core/registry.py``): ``Registry.register_module`` records a
class, as a decorator or as a call; ``Registry.build(cfg, **default_args)``
pops ``cfg["NAME"]``, merges the rest over ``default_args`` and constructs.

A registry also reads as the dict the port kept before it:
``reg[name]`` (``KeyError`` for a name it lacks), iteration over the
names, ``keys()``, ``items()`` and ``values()``.
"""
from __future__ import annotations

import copy
from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterator, Optional


def build_from_cfg(cfg: Dict[str, Any], registry: "Registry",
                   default_args: Optional[Dict[str, Any]] = None) -> Any:
    """Construct ``registry.get(cfg["NAME"])`` with the other keys of
    ``cfg`` over ``default_args`` (``cfg`` wins; ``NAME`` is not passed
    on and may be a callable). The class that fails is named in front of
    its error, which keeps its type."""
    if not isinstance(cfg, Mapping):
        raise TypeError(f"cfg must be a mapping, got {type(cfg)}")
    if "NAME" not in cfg and "NAME" not in (default_args or {}):
        raise KeyError(f'`cfg` or `default_args` must contain the key '
                       f'"NAME", got {cfg}')
    args = dict(default_args) if default_args else {}
    args.update(copy.deepcopy(dict(cfg)))
    name = args.pop("NAME")
    if isinstance(name, str):
        obj_cls = registry.get(name)
        if obj_cls is None:
            raise KeyError(f"{name} is not in the {registry.name} registry. "
                           f"Known: {sorted(registry.module_dict)}")
    elif callable(name):
        obj_cls = name
    else:
        raise TypeError(f"NAME must be a str or callable, got {type(name)}")
    try:
        return obj_cls(**args)
    except Exception as e:
        raise type(e)(f"{obj_cls.__name__}: {e}") from e


class Registry:
    def __init__(self, name: str, build_func: Optional[Callable] = None):
        self._name = name
        self._module_dict: Dict[str, Any] = {}
        self.build_func = build_func or build_from_cfg

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return self._module_dict

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def __repr__(self) -> str:
        return (f"Registry(name={self._name}, "
                f"items={sorted(self._module_dict)})")

    def get(self, key: str) -> Any:
        return self._module_dict.get(key)

    def __getitem__(self, key: str) -> Any:
        return self._module_dict[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._module_dict)

    def keys(self):
        return self._module_dict.keys()

    def items(self):
        return self._module_dict.items()

    def values(self):
        return self._module_dict.values()

    def build(self, cfg: Dict[str, Any], **default_args: Any) -> Any:
        return self.build_func(cfg, self, default_args or None)

    def _register(self, module_class: Any, module_name: Optional[str] = None,
                  force: bool = False) -> None:
        name = module_name or module_class.__name__
        if not force and name in self._module_dict:
            raise KeyError(f"{name} is already registered in {self.name}")
        self._module_dict[name] = module_class

    def register_module(self, name: Optional[str] = None, force: bool = False,
                        module: Any = None):
        """``@REG.register_module()`` / ``@REG.register_module(name=...)``,
        or ``REG.register_module(name=..., module=cls)``."""
        if module is not None:
            self._register(module, name, force)
            return module

        def _decorator(cls):
            self._register(cls, name, force)
            return cls

        return _decorator
