"""What ``BENCHMARK.json`` names, found by name under ``perfbench/``.

  * a configuration: the ``file`` its entry gives (``configs/<name>.json``);
  * a traffic mix: ``traffic/<name>.json``;
  * a cell's own settings (batch, correctness limits): ``cells/<name>.json``;
  * a metric, end-to-end or per layer: ``metrics/<name>.py``, a reader
    with ``read(run) -> float | None`` and, where it needs spans inside the
    program, ``SPANS = {span name: "module:Class.attr"}``.

Adding a configuration, a mix, a cell or a metric adds files and entries;
no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


class Spec:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self._readers: dict = {}

    def _json(self, rel: str) -> dict:
        return json.loads((self.root / rel).read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return self._json(c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json(f"perfbench/traffic/{name}.json")

    def cell_settings(self, name: str) -> dict:
        return self._json(f"perfbench/cells/{name}.json")

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        mod = self._readers.get(metric)
        if mod is None:
            path = self.root / "perfbench" / "metrics" / f"{metric}.py"
            loaded = importlib.util.spec_from_file_location(
                "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
            mod = importlib.util.module_from_spec(loaded)
            loaded.loader.exec_module(mod)
            self._readers[metric] = mod
        return mod
