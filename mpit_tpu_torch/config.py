"""Command-line flags from a config dataclass: one ``--flag`` per field.

The port's copy of the ``asyncsgd.config`` pattern of the JAX package
(``add_dataclass_args`` / ``from_argv``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Type, TypeVar

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
    cls: Type[T], argv: list[str] | None = None, *, prog: str | None = None
) -> T:
    """Build a config dataclass from CLI args."""
    parser = argparse.ArgumentParser(prog=prog, description=cls.__doc__)
    add_dataclass_args(parser, cls)
    ns = parser.parse_args(argv)
    return cls(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(cls)})
