"""The parts a cell names, found by name.

Each part of the benchmark that belongs to one traffic mix or one metric
is a file of its own, ``<bench>/<kind>/<name>.py``, loaded by path:

* ``drivers/<driver>.py``: ``Driver``, the closed loop a traffic file's
  ``driver`` names;
* ``entries/<entry>.py``: ``make(inputs, kwargs, device)``, the object of
  the public API a traffic file's ``entry`` names;
* ``reference/<reference>.py``: ``run(inputs, solvers, device, dtype)``,
  the plain reference a traffic file's ``reference`` names;
* ``metrics/<metric>.py``: ``read(ctx)``, a per-layer metric's reader;
* ``phantoms/<kind>.py``: ``make(spec, nslice, n, device)``, the volume a
  configuration's ``phantom`` names.

A later cell or configuration that needs a new one adds a file; no file
that is there changes.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent
KINDS = ("drivers", "entries", "reference", "metrics", "phantoms")


def module(kind: str, name: str, bench: Path = HERE):
    """The module of `<bench>/<kind>/<name>.py`."""
    if kind not in KINDS:
        raise ValueError(f"no kind of part {kind!r}")
    path = Path(bench) / kind / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {kind} part {name!r}: {path} is missing")
    tag = f"benchmark_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
