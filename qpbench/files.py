"""Files found by name.

A traffic kind, a weight family, a head format and a per-layer metric
each live in a Python file of their own, which the harness loads by the
name that a mix, a configuration or ``BENCHMARK.json`` gives:

- ``kinds/<kind>.py``: the window that drives one entry point of the
  program, its check sample and the numbers its check compares;
- ``reference/families/<family>.py``: the plain decoder of one packed
  weight format;
- ``reference/heads/<head>.py`` and ``heads/<head>.py``: a head format's
  plain logits and its installation in the program;
- ``metrics/<metric>.py``: the reader of one metric.

So a later change adds a kind, a family, a head or a metric by adding a
file, and edits none.  ``root`` is the ``qpbench`` folder of a checkout.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
_LOADED: dict = {}


def load(folder: str, name: str, root: Path = ROOT):
    """The module ``root/folder/name.py``, loaded once a path."""
    path = Path(root) / folder / f"{name}.py"
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"no {folder} {name!r}: {path}")
        key = re.sub(r"\W", "_", f"qpbench_{folder}_{name}")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
