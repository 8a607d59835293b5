"""Command-line flags from a config dataclass: one ``--flag`` per field.

The port's copy of the ``asyncsgd.config`` pattern of the JAX package
(``add_dataclass_args`` / ``from_argv``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Mapping, Type, TypeVar

__all__ = ["add_dataclass_args", "from_argv"]

T = TypeVar("T")


def _str2bool(v: str) -> bool:
    if v.lower() in ("1", "true", "yes", "on"):
        return True
    if v.lower() in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def add_dataclass_args(parser: argparse.ArgumentParser, cls: Type[Any]) -> None:
    """Add one ``--flag`` per dataclass field (bools accept true/false)."""
    for f in dataclasses.fields(cls):
        name = "--" + f.name.replace("_", "-")
        default = (
            f.default
            if f.default is not dataclasses.MISSING
            else f.default_factory()  # type: ignore[misc]
        )
        typ = _str2bool if f.type in (bool, "bool") else type(default)
        parser.add_argument(name, type=typ, default=default, help=f"({default})")


def from_argv(
    cls: Type[T],
    argv: list[str] | None = None,
    *,
    prog: str | None = None,
    overrides: Mapping[str, Any] | None = None,
    later: Mapping[str, str] | None = None,
) -> T:
    """Build a config dataclass from CLI args; ``overrides`` (field name
    to value) replace what the args gave. ``later`` maps flags that are
    not fields (as field names) to the slice of the port that brings
    them: each parses, and giving it raises ``SystemExit`` naming that
    slice."""
    parser = argparse.ArgumentParser(prog=prog, description=cls.__doc__)
    add_dataclass_args(parser, cls)
    for name in later or {}:
        parser.add_argument(
            "--" + name.replace("_", "-"), default=argparse.SUPPRESS, help=argparse.SUPPRESS
        )
    ns = parser.parse_args(argv)
    for name, slice_name in (later or {}).items():
        if hasattr(ns, name):
            raise SystemExit(
                f"--{name.replace('_', '-')} {getattr(ns, name)}: not in this port yet; "
                f"it arrives with {slice_name}"
            )
    kw = {f.name: getattr(ns, f.name) for f in dataclasses.fields(cls)}
    if overrides:
        kw.update(overrides)
    return cls(**kw)
