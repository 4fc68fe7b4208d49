"""``BENCHMARK.json`` and the files it names: a cell's configuration, its
traffic mix, its system, its reference and its metrics, each found by name.

- a configuration is ``configs/<name>.json`` (the file the manifest names);
- a traffic mix is ``mixes/<traffic>.json``, read by ``harness.runner``;
- a system is ``systems/<cfg["system"]>.py`` and a reference
  ``reference/<cfg["reference"]>.py``;
- a per-layer metric is ``metrics/<metric name>.py`` with a ``read``, and
  so is an end-to-end metric whose source is ``device_trace``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_module(path: Path, name: Optional[str] = None) -> ModuleType:
    """The module in ``path``, loaded by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        name or "perfbench_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str) -> bool:
    """Does ``cell`` report ``metric`` (no ``workloads`` key: every cell)?"""
    return cell in metric.get("workloads", [cell])


def traced(metric: dict) -> bool:
    """Is ``metric`` read from a trace of the card, by a reader of its own?"""
    return metric["source"] == "device_trace"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    system: ModuleType
    reference: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, ModuleType]


def cell(name: str, overrides: Optional[dict] = None,
         root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest with everything it names loaded.
    ``overrides`` replaces top-level keys of the configuration or, under
    "mix", of the traffic mix (the tests' small sizes)."""
    man = manifest(root)
    work = next((w for w in man["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in man['workloads']]}")
    conf = next(c for c in man["configs"] if c["name"] == work["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((BENCH / "mixes" / f"{work['traffic']}.json")
                     .read_text())
    overrides = dict(overrides or {})
    mix.update(overrides.pop("mix", {}))
    cfg.update(overrides)
    per_layer = [m for m in man["per_layer"] if reports(m, name)]
    end_to_end = [m for m in man["end_to_end"] if reports(m, name)]
    read = per_layer + [m for m in end_to_end if traced(m)]
    return Cell(
        name=name, config=cfg, mix=mix,
        system=load_module(BENCH / "systems" / f"{cfg['system']}.py"),
        reference=load_module(BENCH / "reference" / f"{cfg['reference']}.py"),
        end_to_end=end_to_end, per_layer=per_layer,
        readers={m["name"]: load_module(BENCH / "metrics" / f"{m['name']}.py")
                 for m in read})
