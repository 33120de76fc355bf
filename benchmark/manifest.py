"""The benchmark's manifest: ``BENCHMARK.json`` at the root of the
checkout, and the files it names, each found by its name.

- a cell (``workloads``) names a configuration and a traffic mix;
- a configuration's sizes are in the file its entry names
  (``benchmark/configs/<config>.json``), its plain reference in
  ``benchmark/reference/<config>.py`` and the program's side in
  ``benchmark/adapters/<config>.py``;
- a traffic mix, the job a modeller runs (sampler scheme, chains, warm-up,
  warm start, the limits of the output check), is
  ``benchmark/workloads/<traffic>.json``;
- every metric, end to end or per layer, has its reader in
  ``benchmark/metrics/<metric>.py``.

A new cell, configuration or metric is new files and a new entry in
``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Manifest:
    """``BENCHMARK.json`` of the checkout at ``root`` and the files it
    names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.here = self.root / "benchmark"

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry, = [c for c in self.bench["configs"] if c["name"] == name]
        return {**json.loads((self.root / entry["file"]).read_text()),
                "name": name}

    def traffic(self, name: str) -> dict:
        return json.loads((self.here / "workloads" / f"{name}.json").read_text())

    def reference(self, config: str):
        return self._module("reference", config)

    def adapter(self, config: str):
        return self._module("adapters", config)

    def reader(self, metric: str):
        return self._module("metrics", metric)

    def metrics(self, kind: str, cell: str) -> list[dict]:
        """The ``kind`` ("end_to_end" or "per_layer") metrics that ``cell``
        reports: those that list it, and those that list no cells and move
        an end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.bench["end_to_end"]
               if cell in m.get("workloads", [cell])}
        out = []
        for m in self.bench[kind]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m.get("moves") in e2e:
                out.append(m)
        return out

    def _module(self, folder: str, name: str):
        """The module ``benchmark/<folder>/<name>.py``, loaded by its path
        (a name may hold a dot or a dash)."""
        mod_name = f"benchmark.{folder}.{name}"
        if mod_name in sys.modules:
            return sys.modules[mod_name]
        path = self.here / folder / f"{name}.py"
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or not path.exists():
            raise FileNotFoundError(f"{path} (for {folder} {name!r})")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        return mod
