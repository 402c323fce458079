"""Package exports resolved on first use (PEP 562), so importing one light
module of a package (``net.protocol``, ``obs.blackbox``, ``ckpt.tiered``)
loads neither its siblings nor PyTorch. A cluster replica process is pure
host code and imports only such modules."""

from __future__ import annotations

import importlib
from typing import Callable, Dict


def exports(package: str, homes: Dict[str, str]) -> Callable[[str], object]:
    """``__getattr__`` for ``package``: a name of ``homes`` loads its
    module (``homes[name]``, relative to the package) and any other name
    is tried as a submodule."""

    def __getattr__(name: str):
        home = homes.get(name)
        if home is not None:
            return getattr(importlib.import_module(f"{package}.{home}"),
                           name)
        if not name.startswith("__"):
            try:
                return importlib.import_module(f"{package}.{name}")
            except ModuleNotFoundError as ex:
                if ex.name != f"{package}.{name}":
                    raise
        raise AttributeError(
            f"module {package!r} has no attribute {name!r}")

    return __getattr__
