# Copied from dualdiffusion_tpu/utils/config.py.
"""Config substrate: JSON -> nested-dataclass hydration + environment paths.

Capability parity with the reference's config system
(reference: src/utils/config.py:87-194) redesigned for this framework:

  * ``load_config(cls, path)`` hydrates a (possibly nested) dataclass from a
    JSON/JSON5 file, recursively instantiating nested dataclasses, lists and
    dicts of dataclasses, warning on unknown fields and on missing fields
    without defaults.
  * ``save_config(obj, path)`` writes a dataclass back to JSON (copy-on-write:
    writes to a temp file then atomically renames, so an interrupt can never
    leave a truncated config on disk — reference: src/utils/config.py:55-70).
  * Environment constants (CONFIG_PATH, MODELS_PATH, DATASET_PATH, DEBUG_PATH,
    CACHE_PATH) loaded from the process environment or an optional ``.env``
    file at the repo root.

JSON5 is accepted when ``pyjson5`` is importable; otherwise a small
comment-stripping fallback handles the ``//``-comment subset the project uses.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import tempfile
import typing
from dataclasses import MISSING, fields, is_dataclass
from pathlib import Path
from typing import Any, Optional, Type, TypeVar, Union

logger = logging.getLogger(__name__)

T = TypeVar("T")

try:  # optional json5 support
    import pyjson5  # type: ignore

    def _loads(text: str) -> Any:
        return pyjson5.loads(text)
except Exception:  # pragma: no cover - depends on env
    _COMMENT_RE = re.compile(r'("(?:[^"\\]|\\.)*")|//[^\n]*|/\*.*?\*/', re.DOTALL)
    _TRAILING_COMMA_RE = re.compile(r",(\s*[}\]])")

    def _loads(text: str) -> Any:
        # strip //... and /*...*/ comments outside string literals, then
        # trailing commas — the JSON5 subset used by project config files
        text = _COMMENT_RE.sub(lambda m: m.group(1) or "", text)
        text = _TRAILING_COMMA_RE.sub(r"\1", text)
        return json.loads(text)


# ---------------------------------------------------------------------------
# environment paths
# ---------------------------------------------------------------------------

def _load_dotenv() -> None:
    env_file = Path(os.environ.get("DUALDIFFUSION_ENV_FILE", Path.cwd() / ".env"))
    if not env_file.is_file():
        return
    for line in env_file.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, val = line.partition("=")
        os.environ.setdefault(key.strip(), val.strip().strip('"').strip("'"))


_load_dotenv()

CONFIG_PATH: Optional[str] = os.environ.get("CONFIG_PATH")
MODELS_PATH: Optional[str] = os.environ.get("MODELS_PATH")
DATASET_PATH: Optional[str] = os.environ.get("DATASET_PATH")
DEBUG_PATH: Optional[str] = os.environ.get("DEBUG_PATH")
CACHE_PATH: Optional[str] = os.environ.get("CACHE_PATH")
NO_GUI: bool = os.environ.get("NO_GUI", "0") == "1"


# ---------------------------------------------------------------------------
# json io (atomic writes)
# ---------------------------------------------------------------------------

def load_json(path: Union[str, Path]) -> Any:
    with open(path, "rt", encoding="utf-8") as f:
        return _loads(f.read())


def save_json(obj: Any, path: Union[str, Path], indent: int = 2) -> None:
    """Atomic (copy-on-write) json save: temp file + rename."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wt", encoding="utf-8") as f:
            json.dump(obj, f, indent=indent)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


# ---------------------------------------------------------------------------
# dataclass hydration
# ---------------------------------------------------------------------------

def _unwrap_optional(tp: Any) -> Any:
    origin = typing.get_origin(tp)
    if origin is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _hydrate(tp: Any, value: Any, where: str) -> Any:
    tp = _unwrap_optional(tp)
    if value is None:
        return None
    if is_dataclass(tp) and isinstance(tp, type):
        if not isinstance(value, dict):
            raise TypeError(f"{where}: expected mapping for {tp.__name__}, got {type(value).__name__}")
        return _from_dict(tp, value, where)
    origin = typing.get_origin(tp)
    if origin in (list, tuple):
        args = typing.get_args(tp)
        elem_tp = args[0] if args else Any
        seq = [_hydrate(elem_tp, v, f"{where}[{i}]") for i, v in enumerate(value)]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        args = typing.get_args(tp)
        val_tp = args[1] if len(args) == 2 else Any
        return {k: _hydrate(val_tp, v, f"{where}[{k!r}]") for k, v in value.items()}
    return value


def _from_dict(cls: Type[T], data: dict, where: str) -> T:
    known = {f.name: f for f in fields(cls)}
    hints = typing.get_type_hints(cls)
    kwargs: dict = {}
    for key, value in data.items():
        if key not in known:
            logger.warning("config %s: unknown field '%s' for %s (ignored)", where, key, cls.__name__)
            continue
        kwargs[key] = _hydrate(hints.get(key, Any), value, f"{where}.{key}")
    for name, f in known.items():
        if name not in kwargs and f.default is MISSING and f.default_factory is MISSING:  # type: ignore[misc]
            logger.warning("config %s: missing required field '%s' for %s", where, name, cls.__name__)
    return cls(**kwargs)


def config_from_dict(cls: Type[T], data: dict) -> T:
    """Hydrate dataclass ``cls`` from a plain dict (recursively)."""
    return _from_dict(cls, data, cls.__name__)


def load_config(cls: Type[T], path: Union[str, Path]) -> T:
    """Load a JSON/JSON5 file into dataclass ``cls``.

    Reference behavior: src/utils/config.py:87-166 (recursive instantiation,
    unknown/missing field warnings).
    """
    return config_from_dict(cls, load_json(path))


def config_to_dict(obj: Any) -> Any:
    if is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: config_to_dict(getattr(obj, f.name)) for f in fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [config_to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: config_to_dict(v) for k, v in obj.items()}
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:  # np/jnp scalar
        return obj.item()
    return obj


def save_config(obj: Any, path: Union[str, Path]) -> None:
    save_json(config_to_dict(obj), path)
