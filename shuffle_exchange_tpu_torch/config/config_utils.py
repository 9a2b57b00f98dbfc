"""Typed-config base machinery (the port's own copy of the JAX package's
``config/config_utils.py``, which imports no JAX but is still not
imported from here).

Capability parity with the reference's ``runtime/config_utils.py``
(``DeepSpeedConfigModel``): dict-in, validated-dataclass-out, with

- field aliases (old config key spellings keep working),
- deprecated fields that forward their value to a replacement field,
- strict unknown-key warnings (typos surface immediately),
- nested sub-model instantiation from plain dicts.

Implemented on dataclasses (no pydantic dependency) so configs are cheap
and picklable.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional, Type, TypeVar

from ..utils.logging import logger

T = TypeVar("T", bound="ConfigModel")


class ConfigError(Exception):
    """Raised for invalid or not-yet-supported configuration (reference:
    DeepSpeedConfigError)."""


def config_field(default=dataclasses.MISSING, *, default_factory=dataclasses.MISSING,
                 aliases=(), deprecated=False, new_param: Optional[str] = None,
                 model: Optional[type] = None, ge=None, le=None, gt=None, lt=None):
    """A dataclass field carrying config metadata (aliases/deprecation/bounds).

    ``model`` declares the nested ConfigModel class for Optional sections whose
    default is None (sections with a non-None default declare it implicitly via
    ``default_factory``).
    """
    metadata = {
        "aliases": tuple(aliases),
        "deprecated": deprecated,
        "new_param": new_param,
        "model": model,
        "ge": ge, "le": le, "gt": gt, "lt": lt,
    }
    if default_factory is not dataclasses.MISSING:
        return field(default_factory=default_factory, metadata=metadata)
    return field(default=default, metadata=metadata)


@dataclass
class ConfigModel:
    """Base class: construct with ``from_dict``; validates bounds and types."""

    @classmethod
    def from_dict(cls: Type[T], data: Optional[Dict[str, Any]] = None, path: str = "") -> T:
        data = dict(data or {})
        # Accept {"enabled": bool} shorthand sections uniformly.
        kwargs: Dict[str, Any] = {}
        known_keys = set()
        field_by_name = {f.name: f for f in fields(cls)}
        for f in fields(cls):
            names = [f.name] + list(f.metadata.get("aliases", ()))
            known_keys.update(names)
            value_found = dataclasses.MISSING
            for name in names:
                if name in data:
                    value_found = data[name]
                    break
            if value_found is dataclasses.MISSING:
                continue
            if f.metadata.get("deprecated"):
                new_param = f.metadata.get("new_param")
                logger.warning(f"Config key '{path}{f.name}' is deprecated" + (f"; use '{new_param}'" if new_param else ""))
                if new_param:
                    target = field_by_name.get(new_param)
                    if target is not None:
                        kwargs.setdefault(new_param, _coerce(target, value_found, path))
                    else:
                        kwargs.setdefault(new_param, value_found)
                    continue
            kwargs[f.name] = _coerce(f, value_found, path)
        unknown = set(data.keys()) - known_keys
        for key in sorted(unknown):
            logger.warning(f"Unknown config key ignored: '{path}{key}'")
        obj = cls(**kwargs)  # type: ignore[arg-type]
        obj._validate(path)
        return obj

    def _validate(self, path: str = "") -> None:
        for f in fields(self):
            value = getattr(self, f.name)
            if value is None:
                continue
            for bound, op, sym in (("ge", lambda v, b: v >= b, ">="), ("le", lambda v, b: v <= b, "<="),
                                   ("gt", lambda v, b: v > b, ">"), ("lt", lambda v, b: v < b, "<")):
                b = f.metadata.get(bound) if f.metadata else None
                if b is not None and not op(value, b):
                    raise ConfigError(f"Config '{path}{f.name}'={value} violates constraint {sym} {b}")

    def to_dict(self) -> Dict[str, Any]:
        def convert(v):
            if isinstance(v, ConfigModel):
                return v.to_dict()
            if isinstance(v, (list, tuple)):
                return [convert(x) for x in v]
            if isinstance(v, dict):
                return {k: convert(x) for k, x in v.items()}
            return v
        return {f.name: convert(getattr(self, f.name)) for f in fields(self)}

    def dump(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)


def _coerce(f, value, path):
    """Instantiate nested ConfigModel fields from dicts; light scalar coercion."""
    tp = f.type
    # Explicit JSON null on an Optional field means "absent".
    if value is None:
        return None
    # Resolve nested ConfigModel subclasses declared via default_factory or
    # explicit model= metadata (for Optional sections defaulting to None).
    factory = f.default_factory if f.default_factory is not dataclasses.MISSING else None
    if not (isinstance(factory, type) and issubclass(factory, ConfigModel)):
        factory = f.metadata.get("model") if f.metadata else None
    if isinstance(factory, type) and issubclass(factory, ConfigModel):
        if isinstance(value, dict):
            return factory.from_dict(value, path=f"{path}{f.name}.")
        if isinstance(value, bool):  # {"section": true} shorthand
            return factory.from_dict({"enabled": value}, path=f"{path}{f.name}.")
        if isinstance(value, factory):
            return value
        raise ConfigError(f"Config '{path}{f.name}' expects a dict, got {type(value).__name__}")
    # Scalar coercions: "1e8" strings and float-ints appear in real DS configs.
    tp_str = tp if isinstance(tp, str) else getattr(tp, "__name__", str(tp))
    if tp_str in ("bool", "Optional[bool]") and isinstance(value, str):
        lowered = value.strip().lower()
        if lowered in ("true", "1", "yes", "on"):
            return True
        if lowered in ("false", "0", "no", "off"):
            return False
        raise ConfigError(f"Config '{path}{f.name}' expects a bool, got {value!r}")
    if tp_str in ("List[int]", "list[int]") and isinstance(value, (list, tuple)):
        try:
            return [int(float(v)) for v in value]
        except (TypeError, ValueError):
            raise ConfigError(f"Config '{path}{f.name}' expects a list of ints, got {value!r}")
    if tp_str in ("int", "Optional[int]") and isinstance(value, (float, str)):
        try:
            return int(float(value))
        except ValueError:
            raise ConfigError(f"Config '{path}{f.name}' expects an int, got {value!r}")
    if tp_str in ("float", "Optional[float]") and isinstance(value, (int, str)):
        try:
            return float(value)
        except ValueError:
            raise ConfigError(f"Config '{path}{f.name}' expects a float, got {value!r}")
    return value
