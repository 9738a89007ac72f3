"""The manifest (`BENCHMARK.json`) and the files it names, found by name.

A configuration names its architecture (`"architecture"`, CLIP where the
key is absent); the architecture's reference is `reference/arch/<name>.py`
and its operation counts are `work/<name>.py`, each found in the first of
its directories that holds the file.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, List, Optional

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"
DEFAULT_ARCHITECTURE = "clip"
ARCHITECTURE_DIRS = [BENCH / "reference" / "arch"]
WORK_DIRS = [BENCH / "work"]
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One cell of the manifest with everything it names."""
    name: str
    chips: int
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    check: dict          # workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: Optional[dict] = None) -> Cell:
    manifest = manifest or load_json(MANIFEST)
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if not entries:
        known = ", ".join(w["name"] for w in manifest["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")
    w = entries[0]
    config_entry = next(c for c in manifest["configs"]
                        if c["name"] == w["config"])
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(ROOT / config_entry["file"]),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        check=load_json(BENCH / "workloads" / f"{name}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)])


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str):
    """The traffic driver `traffic/<kind>.py`."""
    return _module(BENCH / "traffic" / f"{kind}.py",
                   f"benchmark_traffic_{kind}")


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    """`read(run)` of `metrics/<name>.py`."""
    mod = _module(BENCH / "metrics" / f"{name}.py",
                  "benchmark_metric_" + name.replace(".", "_"))
    return mod.read


def architecture_name(config: dict) -> str:
    return config.get("architecture", DEFAULT_ARCHITECTURE)


def _by_name(dirs: List[Path], name: str, kind: str):
    for d in dirs if _NAME.fullmatch(name) else ():
        path = d / f"{name}.py"
        if path.is_file():
            return _module(path, f"benchmark_{kind}_{name}".replace(".", "_"))
    known = sorted({p.stem for d in dirs for p in d.glob("*.py")})
    raise KeyError(f"no {kind} module for architecture {name!r} (known: "
                   f"{', '.join(known)})")


def architecture(config: dict):
    """The reference module of the configuration's architecture."""
    return _by_name(ARCHITECTURE_DIRS, architecture_name(config),
                    "architecture")


def work_counts(config: dict):
    """The operation counts module of the configuration's architecture."""
    return _by_name(WORK_DIRS, architecture_name(config), "work")
