"""Keeps jax, jaxlib, flax and the JAX package `libav_tpu` out of the
process: the benchmark measures the port alone.

Names are compared whole by their top-level part (before the first dot),
so `libav_tpu_torch` passes and `libav_tpu.x` is refused.
"""

from __future__ import annotations

import importlib.abc
import sys
from typing import Iterable, List

REFUSED = ("jax", "jaxlib", "flax", "libav_tpu")


def top(name: str) -> str:
    return name.split(".", 1)[0]


class Refuse(importlib.abc.MetaPathFinder):
    """A meta-path finder that raises for every refused top-level name."""

    def __init__(self, refused: Iterable[str] = REFUSED):
        self.refused = frozenset(refused)

    def find_spec(self, name, path=None, target=None):
        if top(name) in self.refused:
            raise ModuleNotFoundError(
                f"import of {name} refused: the benchmark runs the port "
                "without jax and without the JAX package")
        return None


def install(refused: Iterable[str] = REFUSED) -> Refuse:
    """Put a Refuse finder first on sys.meta_path; -> the finder."""
    finder = Refuse(refused)
    sys.meta_path.insert(0, finder)
    return finder


def loaded(refused: Iterable[str] = REFUSED, modules=None) -> List[str]:
    """The names in sys.modules (or `modules`) whose top-level part is
    refused, sorted."""
    refused = frozenset(refused)
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top(n) in refused)
