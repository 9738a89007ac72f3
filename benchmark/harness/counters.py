"""The program's own counters, each named by a file of its own.

`counters/<name>.json` says where the program keeps the counter `<name>`:
`{"module": "ttl_tpu_torch.ops.ln_matmul", "attribute":
"ln_matmul.linear_launches"}`, an attribute path inside the module that
holds a whole number. `read()` gives every counter that the program has;
one whose module or attribute it lacks (an older or newer program) is left
out. A counter is added with a file and read by a metric file; nothing
here changes.
"""
from __future__ import annotations

import importlib
from typing import Dict

from .manifest import BENCH, load_json

DIR = BENCH / "counters"


def read() -> Dict[str, int]:
    out = {}
    for path in sorted(DIR.glob("*.json")):
        where = load_json(path)
        try:
            value = importlib.import_module(where["module"])
            for part in where["attribute"].split("."):
                value = getattr(value, part)
        except (ModuleNotFoundError, AttributeError):
            continue
        out[path.stem] = int(value)
    return out


def grown(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    """How much each counter read at both ends grew between them."""
    return {k: after[k] - before[k] for k in after if k in before}
