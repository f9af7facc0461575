"""A copy of the benchmark's files at test sizes, in a temporary root.

Each configuration a cell names is cut by its kind's test sizes,
``sizes/<kind>.py``: ``shrink(config, config_dir)`` rewrites the
configuration (and any frozen plan beside it) to a size the CPU serves,
and ``shrink_cell(cell)`` cuts a cell's clients and check sample, unless
the cell's own traffic and check are asked for.  A new kind brings its
sizes as a new file there.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
from pathlib import Path
from types import ModuleType

from portbench import catalog

SIZES = Path(__file__).resolve().parent / "sizes"


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def sizes(kind: str) -> ModuleType:
    """``sizes/<kind>.py``: the test sizes of one kind."""
    path = SIZES / f"{kind}.py"
    if not path.is_file():
        raise FileNotFoundError(f"kind {kind!r} has no test sizes ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_test_sizes_{kind.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_root(tmp: Path, shrink_cells: bool = True) -> Path:
    """``tmp`` holding BENCHMARK.json and a tiny copy of portbench/;
    ``shrink_cells=False`` keeps every cell's traffic and check."""
    src = catalog.ROOT
    shutil.copy(src / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(src / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    cfgs = catalog.config_dir(tmp)
    kinds = {}
    for path in sorted((tmp / "portbench" / "cells").glob("*.json")):
        name = json.loads(path.read_text())["config"]
        if name not in kinds:
            config = catalog.config(name, tmp)
            kinds[name] = config["kind"]
            sizes(config["kind"]).shrink(config, cfgs)
            _write(cfgs / f"{name}.json", config)
    if not shrink_cells:
        return tmp
    for path in (tmp / "portbench" / "cells").glob("*.json"):
        cell = json.loads(path.read_text())
        sizes(kinds[cell["config"]]).shrink_cell(cell)
        _write(path, cell)
    return tmp
