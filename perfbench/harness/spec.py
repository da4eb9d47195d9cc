"""The benchmark as data: ``BENCHMARK.json`` and the files it names,
found by name and checked against the contract's limits.

Layout under the benchmark folder (``perfbench/``):

- ``configs/<config>.json``: a configuration (``file`` in BENCHMARK.json),
  naming its kind;
- ``kinds/<kind>.py``: what a run of that kind of configuration does: the
  port modules it reaches, its set-up from the seed, its step, the strata
  of the held steps and the check against the plain reference;
- ``traffic/<traffic>.json``: a traffic mix, read by the driver it names;
- ``drivers/<driver>.py``: a way of handing frames to the port;
- ``workloads/<cell>.json``: a cell's own settings (its sample for the
  check, its profile, the limits of ``correct``);
- ``metrics/<metric>.json``: a metric's reader and that reader's arguments;
- ``readers/<reader>.py``: the code that reads a metric;
- ``spans/<span>.json``: a span's targets (module and attribute);
- ``rooflines/<counts>.py``: a kernel's operations and bytes;
- ``reference/``: the plain references the kinds' checks load by path.

A later cell, configuration, traffic mix or metric is new files and
entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class SpecError(ValueError):
    """A file that the benchmark names is missing or breaks a limit."""


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        raise SpecError(f"missing file {path}")
    with open(path) as f:
        return json.load(f)


def _load(mod_name: str, path: str):
    """Execute the file at ``path`` as a module of its own.  The files
    beside it that it imports by their bare names (``from vo_ref import
    ...``) are its folder's: while it runs, its folder leads ``sys.path``
    and no module of such a name is in ``sys.modules``; afterwards those
    names are as they were, so another folder's file of the same name
    is never shadowed."""
    folder = os.path.dirname(path)
    own = {f[:-3] for f in os.listdir(folder) if f.endswith(".py")}
    saved = {n: sys.modules.pop(n) for n in own if n in sys.modules}
    sys.path.insert(0, folder)
    try:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        del sys.path[sys.path.index(folder)]
        for n in own:
            sys.modules.pop(n, None)
        sys.modules.update(saved)
    return mod


class Benchmark:
    """``BENCHMARK.json`` at ``root`` and the folder of data beside it."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.dir = os.path.join(self.root, "perfbench")
        self.spec = _read_json(os.path.join(self.root, "BENCHMARK.json"))
        self.modules = {}

    def _data(self, kind: str, name: str) -> dict:
        return _read_json(os.path.join(self.dir, kind, f"{name}.json"))

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _read_json(os.path.join(self.root, c["file"]))
        raise SpecError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._data("traffic", name)

    def settings(self, cell: str) -> dict:
        return self._data("workloads", cell)

    def metric(self, name: str) -> dict:
        return self._data("metrics", name)

    def span(self, name: str) -> dict:
        return self._data("spans", name)

    def metrics_of(self, cell: str, kind: str) -> list:
        """The entries of ``kind`` ("end_to_end" or "per_layer") that
        ``cell`` reports."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def module(self, folder: str, name: str):
        """``<folder>/<name>.py`` of the benchmark folder, loaded once.
        ``name`` may lead through subfolders (``ba/check``)."""
        path = os.path.join(self.dir, folder, f"{name}.py")
        if path not in self.modules:
            if not os.path.exists(path):
                raise SpecError(f"missing file {path}")
            mod_name = re.sub(r"\W", "_", f"_perfbench_{folder}_{name}")
            self.modules[path] = _load(mod_name, path)
        return self.modules[path]

    def resolve(self, cell: str) -> dict:
        """Everything one run of ``cell`` reads, found by name.  A traffic
        mix that names no driver leaves the stepping to the kind."""
        entry = self.cell(cell)
        config = self.config(entry["config"])
        if "kind" not in config:
            raise SpecError(f"config {entry['config']!r} names no kind")
        traffic = self.traffic(entry["traffic"])
        per_layer = self.metrics_of(cell, "per_layer")
        return {
            "entry": entry,
            "config": config,
            "kind": self.module("kinds", config["kind"]),
            "traffic": traffic,
            "driver": (self.module("drivers", traffic["driver"])
                       if "driver" in traffic else None),
            "settings": self.settings(cell),
            "end_to_end": [(m, self.metric(m["name"]))
                           for m in self.metrics_of(cell, "end_to_end")],
            "per_layer": [(m, self.metric(m["name"])) for m in per_layer],
        }

    def validate(self) -> list:
        """Every breach of the contract's limits that a file can show, as
        text; empty when there is none.  Every cell is resolved, so each
        file it names is found."""
        s = self.spec
        bad = []
        keys = {"command", "paths", "run_seconds", "configs", "workloads",
                "end_to_end", "per_layer"}
        if set(s) != keys:
            bad.append(f"BENCHMARK.json keys {sorted(s)}")
        if not (isinstance(s.get("run_seconds"), int)
                and 1 <= s["run_seconds"] <= 51):
            bad.append("run_seconds must be a whole number 1-51")
        names = {}
        for kind, lo, hi in (("configs", 1, 24), ("workloads", 1, 24),
                             ("end_to_end", 1, 16), ("per_layer", 1, 128)):
            items = s.get(kind, [])
            if not lo <= len(items) <= hi:
                bad.append(f"{kind}: {len(items)} entries")
            for it in items:
                n = it.get("name", "")
                if not NAME.match(n):
                    bad.append(f"{kind}: bad name {n!r}")
                group = "metric" if kind in ("end_to_end", "per_layer") \
                    else kind
                if (group, n) in names:
                    bad.append(f"{kind}: duplicate name {n!r}")
                names[(group, n)] = it
        for m in s.get("end_to_end", []) + s.get("per_layer", []):
            if not UNIT.match(m.get("unit", "")):
                bad.append(f"{m.get('name')}: bad unit {m.get('unit')!r}")
            if m.get("better") not in ("lower", "higher"):
                bad.append(f"{m.get('name')}: better is lower or higher")
            if m.get("source") not in SOURCES:
                bad.append(f"{m.get('name')}: bad source")
            for w in m.get("workloads", []):
                if ("workloads", w) not in names:
                    bad.append(f"{m['name']}: unknown workload {w!r}")
        e2e = {m["name"]: m for m in s.get("end_to_end", [])}
        for m in e2e.values():
            if m.get("source") not in ("host_clock", "device_trace"):
                bad.append(f"{m['name']}: end-to-end source")
            if not 0 < m.get("bound", 0) <= 0.25:
                bad.append(f"{m['name']}: bound must be in (0, 0.25]")
        if "setup_s" not in e2e:
            bad.append("no setup_s")
        for m in s.get("per_layer", []):
            if m.get("moves") not in e2e:
                bad.append(f"{m['name']}: moves {m.get('moves')!r}")
            if not 1 <= len(m.get("layer", "")) <= 200:
                bad.append(f"{m['name']}: layer")
        pairs = set()
        for w in s.get("workloads", []):
            for k in ("config", "traffic"):
                if not NAME.match(w.get(k, "")):
                    bad.append(f"{w['name']}: bad {k}")
            if ("configs", w.get("config")) not in names:
                bad.append(f"{w['name']}: unknown config {w.get('config')!r}")
            if (w.get("config"), w.get("traffic")) in pairs:
                bad.append(f"{w['name']}: config and traffic twice")
            pairs.add((w.get("config"), w.get("traffic")))
            if w.get("chips") not in (1, 4):
                bad.append(f"{w['name']}: chips")
            if not 1 <= len(w.get("why", "")) <= 200 or "\n" in w["why"]:
                bad.append(f"{w['name']}: why")
            try:
                r = self.resolve(w["name"])
                if not any(m["name"] != "setup_s" for m, _ in r["end_to_end"]):
                    bad.append(f"{w['name']}: only setup_s end to end")
                if not r["per_layer"]:
                    bad.append(f"{w['name']}: no per-layer metric")
                for _, md in r["end_to_end"] + r["per_layer"]:
                    self.module("readers", md["reader"])
            except (SpecError, KeyError) as e:
                bad.append(f"{w['name']}: {e}")
        for c in s.get("configs", []):
            if len(c.get("reduced", [])) > 16 or not all(
                    NAME.match(k) for k in c.get("reduced", [])):
                bad.append(f"{c['name']}: reduced")
            if not 1 <= len(c.get("source", "")) <= 200:
                bad.append(f"{c['name']}: source")
            if not any(w.get("config") == c["name"]
                       for w in s.get("workloads", [])):
                bad.append(f"{c['name']}: used by no cell")
        return bad
