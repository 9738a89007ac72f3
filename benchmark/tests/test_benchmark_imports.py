"""Nothing the benchmark loads is JAX or the JAX package: every module of
the harness, the drivers, the readers, the reference with each
configuration's architecture and operation counts, and the program's
counters, with the program, in a fresh interpreter; compared by whole
top-level name (the port's name begins with the JAX package's)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark.harness import (manifest, session, trace, work, images, judge,
                               counters)
from benchmark.reference import run, model, views, tokenizer
m = manifest.load_json(manifest.MANIFEST)
for w in m["workloads"]:
    cell = manifest.load_cell(w["name"], m)
    manifest.architecture(cell.config)
    manifest.work_counts(cell.config)
    manifest.driver(cell.traffic["driver"])
    for metric in cell.per_layer:
        manifest.metric_reader(metric["name"])
import ttl_tpu_torch.predict, ttl_tpu_torch.serve
counters.read()
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
"""


def test_no_jax_in_anything_the_run_loads():
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert {"benchmark", "ttl_tpu_torch", "torch"} <= top
    assert not top & {"jax", "jaxlib", "flax", "ttl_tpu"}
