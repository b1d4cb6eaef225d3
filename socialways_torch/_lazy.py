"""Lazy package exports (PEP 562): a package names its public functions
and classes in its ``__all__``, as the JAX package's ``__init__`` files do,
and loads each one's module on first use, so that importing a package
imports none of its modules (no cycle, no matplotlib, no kernel build)."""

from __future__ import annotations

import importlib
import sys
from typing import Callable, Dict


def lazy_exports(package: str, exports: Dict[str, str]) -> Callable:
    """The module ``__getattr__`` of ``package``: ``exports`` maps each name
    to the module that defines it, relative to ``package`` (``".metrics"``,
    ``"..ops.traj"``).  A name that is its module's own name is the module
    (the JAX ``engine`` exports ``losses``)."""

    def __getattr__(name: str):
        if name not in exports:
            raise AttributeError(f"module {package!r} has no attribute "
                                 f"{name!r}")
        module = importlib.import_module(exports[name], package)
        value = (module if module.__name__.rsplit(".", 1)[1] == name
                 else getattr(module, name))
        setattr(sys.modules[package], name, value)
        return value

    return __getattr__
