"""Find the benchmark's pieces by name: one file each, loaded by path.

- ``drivers/<driver>.py`` (``DRIVER``): how a mix drives the program,
  named by the mix file's ``"driver"``;
- ``generators/<generator>.py`` (``make``): a configuration's graph,
  named by the configuration file's ``"generator"``;
- ``metrics/<metric>.py`` (``read``): one metric's reader; a name
  ``base.suffix`` falls back to ``metrics/<base>.py``.

So a new driver, generator or metric is a new file; nothing that is there
changes.  A file is loaded from the package directory it is asked for
(the tests' copies in temporary directories too) and imports what it
shares by absolute name (``portbench.drivers``, ``portbench.reference``).
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

PKG = Path(__file__).resolve().parent


def path_of(folder: str, name: str, pkg: Path = PKG,
            fallback: bool = False) -> Path:
    """``<pkg>/<folder>/<name>.py``; with ``fallback``, else the file of
    ``name``'s part before the first dot."""
    base = Path(pkg) / folder
    full = base / f"{name}.py"
    if full.exists():
        return full
    short = base / f"{name.split('.')[0]}.py"
    if fallback and short.exists():
        return short
    raise FileNotFoundError(f"no file for {name!r} under {base}")


def load(folder: str, name: str, attr: str, pkg: Path = PKG,
         fallback: bool = False):
    """``attr`` of the module in ``<pkg>/<folder>/<name>.py``."""
    path = path_of(folder, name, pkg, fallback)
    spec = importlib.util.spec_from_file_location(
        f"portbench._found.{folder}.{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, attr):
        raise AttributeError(f"{path} defines no {attr!r}")
    return getattr(mod, attr)
