"""Exports of a package that load on first use, so that importing one
submodule does not import its siblings (and the model zoo behind them)."""

from __future__ import annotations

import importlib
from typing import Dict, Optional


def lazy_getattr(package: str, exports: Dict[str, Optional[str]]):
    """A module ``__getattr__`` for ``package``: ``exports`` maps a name to the
    submodule that defines it, or to None for a submodule of that name."""

    def __getattr__(name):
        if name not in exports:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        if exports[name] is None:
            return importlib.import_module(f"{package}.{name}")
        return getattr(importlib.import_module(f"{package}.{exports[name]}"), name)

    return __getattr__
