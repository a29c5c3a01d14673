"""Find a cell's configuration, traffic mix, limits and metric readers by
name. ``BENCHMARK.json`` at the root of the checkout lists them; each lives
in a file of its own, so a later cell or metric is added as files and
entries only:

- a configuration: the JSON file its entry's ``file`` names;
- a traffic mix: ``<base>/traffic/<traffic>.json``;
- a cell's limits of the comparison that decides ``correct``:
  ``<base>/checks/<cell>.json``;
- a metric's reader: ``<base>/metrics/<metric>.py``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from hpcbench import metrics

ROOT = Path(__file__).resolve().parents[1]
BASE = Path(__file__).resolve().parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(entries, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Bench:
    """``BENCHMARK.json`` (or ``spec``) with the files it names, found under
    ``root`` (configuration files) and ``base`` (the rest)."""

    def __init__(self, root: Path = ROOT, spec: Optional[dict] = None, base: Optional[Path] = None):
        self.root = Path(root)
        self.base = Path(base) if base is not None else BASE
        self.spec = spec if spec is not None else _load(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return _named(self.spec["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = _named(self.spec["configs"], name, "configuration")
        config = _load(self.root / entry["file"])
        if config.get("name", name) != name:
            raise ValueError(f"{entry['file']} holds configuration {config['name']!r}, not {name!r}")
        return {**config, "name": name}

    def traffic(self, name: str) -> dict:
        return {**_load(self.base / "traffic" / f"{name}.json"), "name": name}

    def limits(self, cell: str) -> dict:
        return _load(self.base / "checks" / f"{cell}.json")

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries a cell reports: its per-layer metrics in a
        traced run, its end-to-end metrics otherwise (an entry with a
        ``workloads`` key only in the cells it lists)."""
        entries = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in entries if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        return metrics.reader(metric, self.base / "metrics")
