"""Whether this checkout's CUDA sources compile every kernel of another
checkout's to the same machine code.

    python3 tools/torch_sass_diff.py --parent DIR [SOURCE ...]

Builds each source of `ttl_tpu_torch/csrc/` (default: all) here and in DIR
(the root of a checkout of another commit, for example `git archive` of
the parent unpacked under build/) to a cubin with the package's nvcc
flags, disassembles both with cuobjdump, and compares each kernel of DIR's
build with the kernel of the same name here, instruction for instruction.
Names are compared without the hash of the anonymous namespace (it follows
the file's path) and without a trailing `false` template argument that a
kernel here added to a template of DIR's (`Lb0E`, K6's RMS switch). Prints,
by source, how many of DIR's kernels compiled the same, how many differently
and how many were not found, naming the last two; exits 1 if any differs.
Needs nvcc and cuobjdump (the card's machine has both).
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ttl_tpu_torch.ops import _build  # noqa: E402


def sass(source: Path, out: Path) -> dict:
    """{normalised kernel name: its instructions} of one source's build."""
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-cubin", "-o",
                    str(out), str(source)], check=True)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(out)],
                          capture_output=True, text=True, check=True).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", text)
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"(kernelI(?:Li\d+E)+)Lb0E", r"\1", m.group(1))
            funcs[name] = []
        elif name and line.strip():
            funcs[name].append(line.strip())
    return funcs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of a checkout of another commit")
    ap.add_argument("sources", nargs="*", help="stems under csrc/")
    args = ap.parse_args()
    stems = args.sources or [p.stem for p in _build._sources()]
    differ = False
    with tempfile.TemporaryDirectory() as tmp:
        for stem in stems:
            old = sass(Path(args.parent) / "ttl_tpu_torch" / "csrc"
                       / f"{stem}.cu", Path(tmp) / f"{stem}.old.cubin")
            new = sass(_build.CSRC / f"{stem}.cu",
                       Path(tmp) / f"{stem}.new.cubin")
            changed = [k for k in old if k in new and new[k] != old[k]]
            missing = [k for k in old if k not in new]
            print(f"{stem}: {len(old)} kernels, "
                  f"{len(old) - len(changed) - len(missing)} the same, "
                  f"{len(changed)} different, {len(missing)} not found; "
                  f"{len(new)} kernels here", flush=True)
            for k in changed + missing:
                print(f"  {'different' if k in changed else 'not found'}: "
                      f"{k}", flush=True)
            differ = differ or bool(changed or missing)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
