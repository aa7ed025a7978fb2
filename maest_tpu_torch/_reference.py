"""Load the JAX package's framework-free files without importing JAX.

``maest_tpu/__init__.py`` imports the inference API and with it jax, so a
plain ``import maest_tpu.models.config`` would pull jax into every process
that uses this package. The label tables, the model configuration, the
architecture registry, the mel filterbank and the checkpoint helpers have
no framework in them, so they are loaded here straight from their files,
under the private package name ``_maest_tpu_ref``. Synthetic package
modules whose ``__path__`` points at the JAX package's directories let the
files' relative imports (``from .config import ...``) resolve, and no
``maest_tpu/**/__init__.py`` ever runs. There is one copy of this code:
the JAX package's.
"""

from __future__ import annotations

import importlib
import sys
import types
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent / "maest_tpu"
_PKG = "_maest_tpu_ref"


def _package(name: str, path: Path) -> types.ModuleType:
    mod = sys.modules.get(name)
    if mod is None:
        mod = types.ModuleType(name)
        mod.__path__ = [str(path)]
        mod.__package__ = name
        sys.modules[name] = mod
    return mod


def load(dotted: str) -> types.ModuleType:
    """Import ``maest_tpu.<dotted>`` from its file, e.g. ``"models.config"``.

    Only files whose imports stay inside numpy, the standard library and
    other such files may be loaded this way."""
    if not _ROOT.is_dir():
        raise ImportError(f"reference package not found at {_ROOT}")
    _package(_PKG, _ROOT)
    # every subpackage, so that no relative import (``from ..models.config``)
    # ever reaches a real ``__init__.py``
    for init in _ROOT.glob("*/__init__.py"):
        _package(f"{_PKG}.{init.parent.name}", init.parent)
    return importlib.import_module(f"{_PKG}.{dotted}")
