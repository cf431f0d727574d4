"""Finds everything of a cell by name from ``BENCHMARK.json``: its
configuration file, its traffic mix (``portbench/traffic/<traffic>.json``)
and the mode that mix names (``portbench/traffic/<mode>.py``), its limits (``portbench/limits/<cell>.json``), the reference module the
configuration names (``portbench/reference/<reference>.py``) and the
reader of each per-layer metric (``portbench/metrics/<metric>.py``).  A
later cell, mix or metric is a new file and a new entry; no file here
changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


class BenchmarkError(RuntimeError):
    """The benchmark's files do not define the cell asked for."""


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(root=ROOT):
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise BenchmarkError(f"{path} is missing")
    return load_json(path)


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, bench, name, root=ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise BenchmarkError(f"no workload {name!r} in BENCHMARK.json "
                                 f"(has {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.cfg = load_json(Path(root) / self.config_entry["file"])
        self.traffic = load_json(PKG / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.limits = load_json(PKG / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, name)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if _applies(m, name) and m["moves"] in reported]

    def reference(self):
        return importlib.import_module(
            f"portbench.reference.{self.cfg['reference']}")


def _load(kind, name):
    path = PKG / kind / f"{name}.py"
    if not path.is_file():
        raise BenchmarkError(f"{path} is missing")
    mod_name = f"portbench_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name):
    """The ``read(ctx)`` function of a metric's own file."""
    return _load("metrics", metric_name).read


def mode(mode_name):
    """A traffic mode's module: ``setup(run)`` makes the solves the
    traffic needs before the window and returns what they found,
    ``states(run)`` draws the next call's states (untimed), and
    ``call(run, x0s)`` makes one timed call and returns ``(sol, u0)``.
    ``run`` holds ``prog``, ``stream`` and ``traffic``; a mode may keep
    its own state on it."""
    return _load("traffic", mode_name)
