#!/usr/bin/env python
"""One-command accuracy-parity runbook against the reference's published
table, on the PyTorch port.

The counterpart of tools/parity_all.py: convert -> cache -> run every
published-row config through `python -m ttl_tpu_torch` (each row a process
of its own) with per-row Top-1 assertions at +-0.3%:

    python tools/torch_parity_all.py DATA_ROOT --ckpt ViT-B-16.pt
    python tools/torch_parity_all.py DATA_ROOT --npz clip.npz \\
        --rows ttl,zero-shot --test_sets A

There is no download step (no network): without --ckpt or --npz it exits
asking for one. --ckpt converts through tools/torch_convert_checkpoint.py
into a .npz beside it. Rows, flags, expectations and the results file are
tools/parity_all.py's (coop/cocoop need their trained prompt checkpoints,
else they are SKIPPED with a reason). The rows run on the card; with --cpu
each runs `runner.run` on the CPU instead, with the CLI's parser (tiny
configs only).

Exit code: 0 when every attempted row is within tolerance on every test
set, 1 otherwise. Results are also written to PARITY_RESULTS_TORCH.json.
"""
import argparse
import json
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent

# Published Top-1 per method x test set (BASELINE.md; tools/parity_all.py).
EXPECTED = {
    "zero-shot": {"I": 67.30, "A": 47.14, "V": 59.90, "R": 71.20, "K": 43.00},
    "ensemble":  {"I": 68.50, "A": 48.44, "V": 62.70, "R": 73.50, "K": 45.50},
    "coop":      {"I": 72.30, "A": 49.25, "V": 65.70, "R": 71.50, "K": 47.60},
    "cocoop":    {"I": 71.40, "A": 50.05, "V": 63.80, "R": 73.10, "K": 46.70},
    "tpt":       {"I": 68.90, "A": 54.59, "V": 63.13, "R": 77.05, "K": 47.99},
    "ttl":       {"I": 70.23, "A": 60.51, "V": 64.55, "R": 77.54, "K": 48.61},
}

# Flags reproducing each row, as tools/parity_all.py passes them.
ROW_FLAGS = {
    "zero-shot": ["--tta_steps", "0"],
    "ensemble": ["--ensemble", "--tta_steps", "0"],
    "coop": ["--lora_encoder", "prompt", "--tta_steps", "0",
             "--n_ctx", "4", "--load", "{coop_ckpt}"],
    "cocoop": ["--cocoop", "--tta_steps", "0", "--load", "{cocoop_ckpt}"],
    "tpt": ["--lora_encoder", "prompt", "--tta_steps", "1", "--lr", "5e-3",
            "--n_ctx", "4", "--ctx_init", "a_photo_of_a"],
    "ttl": ["-b", "64", "--lr", "5e-3", "--tta_steps", "1",
            "--layer_range", "9,11", "--init_method", "xavier",
            "--lora_encoder", "image", "--rank", "16"],
}

# the CLI's parse and run on the CPU (the CLI itself runs on the card)
CPU_CLI = ("import sys; from ttl_tpu_torch import cli, runner; "
           "args = cli.build_parser().parse_args(sys.argv[1:]); "
           "runner.run(cli.config_from_args(args), device='cpu', "
           "max_samples=args.max_samples)")


def ensure_checkpoint(args) -> str:
    """The converted .npz cache: --npz as it is, or --ckpt converted beside
    itself once."""
    if args.npz:
        return args.npz
    if args.ckpt is None:
        sys.exit("no checkpoint: pass --ckpt (an OpenAI/HF CLIP checkpoint "
                 "on disk) or --npz (a converted cache); this runbook does "
                 "not download weights")
    npz = str(pathlib.Path(args.ckpt).with_suffix(".npz"))
    if not os.path.exists(npz):
        conv = [sys.executable,
                str(ROOT / "tools" / "torch_convert_checkpoint.py"),
                args.ckpt, "--out", npz]
        if args.arch != "ViT-B/16":
            conv += ["--arch", args.arch]
        r = subprocess.run(conv, capture_output=True, text=True)
        if r.returncode != 0:
            sys.exit(f"convert failed:\n{r.stderr[-2000:]}")
    return npz


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("data_root")
    ap.add_argument("--rows", default="zero-shot,ensemble,coop,cocoop,"
                    "tpt,ttl")
    ap.add_argument("--test_sets", default="A/V/R/K",
                    help="slash-list as in the reference CLI (add I for "
                         "the full ImageNet val row)")
    ap.add_argument("--arch", default="ViT-B/16")
    ap.add_argument("--ckpt", help="local OpenAI/HF checkpoint")
    ap.add_argument("--npz", help="already-converted pytree cache")
    ap.add_argument("--coop_ckpt", help="trained CoOp prompt ckpt for the "
                                        "coop row")
    ap.add_argument("--cocoop_ckpt", help="trained CoCoOp ckpt for the "
                                          "cocoop row")
    ap.add_argument("--tolerance", type=float, default=0.3,
                    help="per-set Top-1 tolerance in percentage points")
    ap.add_argument("--expected_json",
                    help="override the published-expectation table "
                         "(JSON {row: {set: top1}})")
    ap.add_argument("--cpu", action="store_true",
                    help="run every row on the CPU (tiny configs only)")
    ap.add_argument("--out", default=str(ROOT / "PARITY_RESULTS_TORCH.json"))
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                    help="extra flags appended to every CLI invocation")
    args = ap.parse_args(argv)

    expected = EXPECTED
    if args.expected_json:
        expected = json.loads(pathlib.Path(args.expected_json).read_text())

    npz = ensure_checkpoint(args)
    sets = [s for s in args.test_sets.split("/") if s]
    results = {"arch": args.arch, "test_sets": sets,
               "tolerance": args.tolerance, "rows": {}}
    failed = False
    entry = ["-c", CPU_CLI] if args.cpu else ["-m", "ttl_tpu_torch"]

    for row in [r for r in args.rows.split(",") if r]:
        flags = []
        skip = None
        for f in ROW_FLAGS[row]:
            if f == "{coop_ckpt}":
                f = args.coop_ckpt
                skip = skip or (None if f else "needs --coop_ckpt "
                                "(trained CoOp prompt checkpoint)")
            elif f == "{cocoop_ckpt}":
                f = args.cocoop_ckpt
                skip = skip or (None if f else "needs --cocoop_ckpt "
                                "(trained CoCoOp checkpoint)")
            flags.append(f)
        if skip:
            results["rows"][row] = {"skipped": skip}
            print(f"[{row}] SKIPPED: {skip}", flush=True)
            continue

        cmd = [sys.executable, *entry, args.data_root,
               "--test_sets", args.test_sets, "--arch", args.arch,
               "--seed", "0", "--checkpoint_path", npz] + flags + args.extra
        t0 = time.time()
        r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
        row_res = {"cmd": " ".join(cmd), "elapsed_s": round(time.time() - t0),
                   "sets": {}}
        if r.returncode != 0:
            row_res["error"] = r.stderr[-2000:]
            failed = True
            print(f"[{row}] ERROR rc={r.returncode}", flush=True)
        else:
            for s in sets:
                m = re.search(rf"\[{re.escape(s)}\]: @1 ([0-9.]+)/ "
                              rf"@5 ([0-9.]+)", r.stdout)
                if not m:
                    row_res["sets"][s] = {"error": "no summary line"}
                    failed = True
                    continue
                top1 = float(m.group(1))
                want = expected.get(row, {}).get(s)
                ok = want is None or abs(top1 - want) <= args.tolerance
                row_res["sets"][s] = {"top1": top1, "top5": float(m.group(2)),
                                      "expected": want, "ok": ok}
                failed = failed or not ok
                print(f"[{row}][{s}] top1={top1:.2f} expected={want} "
                      f"{'OK' if ok else 'FAIL'}", flush=True)
        results["rows"][row] = row_res

    results["pass"] = not failed
    pathlib.Path(args.out).write_text(json.dumps(results, indent=1) + "\n")
    print(json.dumps({"pass": results["pass"], "out": args.out}))
    sys.exit(0 if results["pass"] else 1)


if __name__ == "__main__":
    main()
