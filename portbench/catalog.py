"""Finding a cell's files by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics; everything else lives under ``portbench/`` in a file named after
what it holds:

``cells/<cell>.json``         the cell: its configuration, its traffic and
                              that traffic's parameters, its server's
                              settings, the sample the output check takes
``configs/<config>.json``     the configuration (and any frozen plan it
                              names beside it)
``kinds/<kind>.py``           how a configuration's workload kind is drawn
                              from the seed and checked against its plain
                              reference, and which server serves it
                              (``SERVER``)
``servers/<server>.py``       how the port is set up, warmed, driven and
                              released for a kind: ``gateway`` (a frozen
                              plan through the async gateway), ``engine``
                              (an LM through ``serve.engine.Engine``)
``traffic/<kind>.py``         one traffic kind's seeded generator
``metrics/<metric>.py``       one metric's reader

A new cell, configuration, kind, server, traffic kind or metric is a new
file and a new entry in ``BENCHMARK.json``: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> Dict:
    return load_json(Path(root) / "portbench" / "cells"
                     / f"{_checked(name)}.json")


def config(name: str, root: Path = ROOT) -> Dict:
    return load_json(Path(root) / "portbench" / "configs"
                     / f"{_checked(name)}.json")


def config_dir(root: Path = ROOT) -> Path:
    return Path(root) / "portbench" / "configs"


def module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """``portbench/<kind>/<name>.py`` loaded from its file (metric names
    hold dots, so they are not import paths)."""
    path = Path(root) / "portbench" / kind / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    # registered before it runs, as an import would be: a dataclass
    # defined in it looks its module up there
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _listed(metric: Dict, cell_name: str) -> bool:
    return cell_name in metric.get("workloads", [cell_name])


def metrics_for(bench: Dict, cell_name: str, trace: bool) -> List[str]:
    """The metrics a run of ``cell_name`` reports: the end-to-end ones
    untraced, the per-layer ones traced.  A metric with no ``workloads``
    list belongs to every cell (a per-layer one to every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m["name"] for m in bench["end_to_end"] if _listed(m, cell_name)]
    if not trace:
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
