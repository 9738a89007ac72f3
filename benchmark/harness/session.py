"""One run of a cell: the traffic driver, the check, the metrics, the line.
"""
from __future__ import annotations

import gc
import json
import math
import shutil
import sys
import tempfile

import numpy as np
import torch

from . import counters, judge
from .device import card_info, process_start_time, require_cards
from .manifest import architecture, driver, load_cell, metric_reader

FORBIDDEN = ("jax", "jaxlib", "flax", "ttl_tpu")


def note(key: str, value) -> None:
    """An earlier line of standard output, for reading."""
    print(f"# {key}: {json.dumps(value, default=str)}", flush=True)


def sample(res: dict, seed: int, n: int):
    """Up to n of the window's distinct items (JPEG, draw index), drawn
    from the seed; and every answer about one of them."""
    items = sorted({res["item"](a["key"]) for a in res["answers"]})
    if not items:
        raise RuntimeError("the window finished no answer to check")
    rng = np.random.default_rng([seed, 0xC4EC])
    picked = [items[i] for i in sorted(rng.permutation(len(items))[:n])]
    chosen = set(picked)
    answers = [a for a in res["answers"] if res["item"](a["key"]) in chosen]
    return picked, answers


def as_answer(key, logits, zero_shot, classnames, topk: int = 5) -> dict:
    """An answer as the program prints it, from logits [C]."""
    probs = torch.softmax(logits.double(), dim=-1)
    order = torch.argsort(probs, descending=True)[:topk].tolist()
    return {"key": key,
            "topk": [(classnames[i], round(float(probs[i]), 6))
                     for i in order],
            "zero_shot_label": classnames[int(zero_shot.argmax())]}


def check(cell, res: dict, seed: int, device,
          control=None) -> tuple[bool, dict]:
    """Judge a sample of the window's answers against the reference. With
    `control` "fp8" the answers judged are the reference's own computed in
    float8, put in the program's place."""
    from benchmark.reference import run as reference

    items, answers = sample(res, seed, cell.check["sample"])
    args = dict(arch=architecture(cell.config), device=device,
                canvas=res["canvas"], block=cell.check["block"])
    listed = [(item, item[0], item[1]) for item in items]
    ref = reference.logits(cell.config, seed, res["classnames"], listed,
                           **args)
    if control == "fp8":
        low = reference.logits(cell.config, seed, res["classnames"], listed,
                               arithmetic="fp8", **args)
        answers = [as_answer(a["key"], *low[res["item"](a["key"])],
                             res["classnames"]) for a in answers]
    by_key = {a["key"]: ref[res["item"](a["key"])] for a in answers}
    values = judge.numbers(answers, by_key, res["classnames"])
    note("checked", {"images": len(items), "answers": len(answers)})
    return judge.decide(values, cell.check["limits"])


def per_layer(cell, res: dict) -> tuple[dict, dict, dict]:
    """(metrics, device extras, breakdown) of a traced run."""
    from .trace import read

    reading = read(res["trace_path"])
    note("trace", reading.summary())
    if res.get("counters"):
        note("traced_counters", {"steps": res.get("traced_steps"),
                                 **res["counters"]})
    run = {"reading": reading, "config": cell.config,
           "traced_steps": res.get("traced_steps"),
           "traced_images": res.get("traced_images"),
           "counters": res.get("counters")}
    metrics = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    extras = {"busy_s": reading.busy_s, "window_s": reading.window_s}
    breakdown = {"device_ops": reading.top_ops(10),
                 "idle_gaps": reading.idle_gaps(10)}
    return metrics, extras, breakdown


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, workdir: str, control=None, rate=None) -> dict:
    """The cell's window and its check. `control` "int8" runs the
    program's int8 frozen prefix; "fp8" judges the float8 reference in the
    program's place."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        # the program's kernels launch on the current device's streams
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    res = driver(cell.traffic["driver"]).run({
        "cell": cell, "seed": seed, "seconds": seconds, "trace": trace,
        "device": device, "t_start": t_start, "workdir": workdir,
        "control": control, "rate": rate})
    res["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if on_card else 0)
    res["launches"] = counters.read()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    res["correct"], res["checks"] = check(cell, res, seed, device, control)
    return res


def main(args) -> int:
    t_start = process_start_time()
    if args.seed < 0:
        print("benchmark: --seed must be a whole number >= 0",
              file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    device = require_cards(cell.chips)
    workdir = tempfile.mkdtemp(prefix="benchmark_")
    try:
        res = execute(cell, args.seed, args.seconds, bool(args.trace),
                      device, t_start, workdir, rate=args.rate)
        card = card_info()
        note("card", {"name": torch.cuda.get_device_name(0), **card})
        note("window", {"setup_s": res["setup_s"], **res["info"]})
        note("launches", res["launches"])
        if args.trace:
            metrics, extras, breakdown = per_layer(cell, res)
        else:
            metrics = {"setup_s": {"value": res["setup_s"], "unit": "s"}}
            units = {m["name"]: m["unit"] for m in cell.end_to_end}
            for name, value in res["end_to_end"].items():
                if name in units:
                    metrics[name] = {"value": value, "unit": units[name]}
            extras, breakdown = {}, None
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; the "
              "benchmark may load no JAX and not the JAX package",
              file=sys.stderr)
        return 3
    device_line = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips,
                   "memory_peak_bytes": res["memory_peak_bytes"], **extras}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics,
            "device": device_line}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        limit = "none" if c["limit"] is None else repr(c["limit"])
        print(f"check {name} {c['value']!r} limit {limit}", file=sys.stderr)
    print(f"check correct {res['correct']}", file=sys.stderr, flush=True)
    if any(isinstance(v["value"], float) and not math.isfinite(v["value"])
           for v in metrics.values()):
        print("benchmark: a metric is not finite", file=sys.stderr)
        return 4
    print(json.dumps(line), flush=True)
    return 0
