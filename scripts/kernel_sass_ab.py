#!/usr/bin/env python3
"""Compare the SASS of every kernel instance in this checkout's CUDA
sources with another checkout's (one GPU machine with ``nvcc``).

    python3 scripts/kernel_sass_ab.py OTHER_CSRC_DIR [SOURCE ...]

Builds each named source (default: every ``csrc/*.cu``) of this checkout
and of ``OTHER_CSRC_DIR`` (another checkout's
``deeplearning4j_tpu_torch/csrc``) with the flags ``utils/cuda_build.py``
uses and ``-Xptxas -v``, into the gitignored
``deeplearning4j_tpu_torch/_build/sass_ab``, dumps each library's SASS with
``cuobjdump -sass``, pairs the kernels of the two trees by name, integer
template arguments and element type (an instance without an element type
argument is the bf16 one of a tensor-core kernel, the f32 one of a SIMT
kernel; a kernel that lost its only integer argument pairs with the
lowest), and prints one JSON line per pair: whether the instruction text
is identical once addresses and encodings are stripped, how many lines
differ, and ptxas's registers and spill bytes on each side.  Instances
only one tree has are printed as unpaired.  Needs ``nvcc`` and
``cuobjdump``; exits non-zero without them.
"""

from __future__ import annotations

import difflib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

_NAME = re.compile(r"(\w+?(?:_kernel|_tiled|_split|_combine))([IE].*)?$")


def key(mangled: str):
    """(kernel, integer template arguments, element type) of a mangled
    kernel name, or None for a name that is not a kernel of csrc/."""
    bare = re.sub(r"^_ZN\d+_GLOBAL__N_+\w*?_cu_\w{8}\d+|^_ZN12_GLOBAL__N_1\d+", "", mangled)
    m = _NAME.match(bare)
    if m is None:
        return None
    base, args = m.group(1), m.group(2) or ""
    args = args if args.startswith("I") else ""
    ints = tuple(int(x) for x in re.findall(r"Li(\d+)E", args))
    if "6__half" in args:
        dtype = "float16"
    elif "13__nv_bfloat16" in args:
        dtype = "bfloat16"
    elif args.startswith("If"):
        dtype = "float32"
    else:
        dtype = "bfloat16" if ("wgmma" in base or "tile_check" in base) else "float32"
    if base.startswith("lstm"):
        dtype = dtype + ("_resident" if "Lb1E" in args else "")
    return base, ints, dtype


def build_all(jobs) -> dict:
    """{(name, side): (library, ptxas log)} for jobs {(name, side): (source,
    library)}, one ``nvcc`` each, all started together."""
    from deeplearning4j_tpu_torch.utils import cuda_build

    procs = {}
    for job, (src, out) in jobs.items():
        out.parent.mkdir(parents=True, exist_ok=True)
        procs[job] = (out, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(src.parent),
             "-o", str(out), str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for job, (out, p) in procs.items():
        log, _ = p.communicate(timeout=1200)
        if p.returncode:
            raise SystemExit(f"nvcc failed for {jobs[job][0]}:\n{log}")
        built[job] = (out, log)
    return built


def ptxas(log: str) -> dict:
    """mangled kernel → {registers, spill_stores, spill_loads}."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
    return out


def sass(lib: Path) -> dict:
    """mangled kernel → its instructions, addresses and encodings stripped."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    out = {}
    for func in text.split("Function : ")[1:]:
        name, body = func.split(None, 1)
        lines = []
        for line in body.splitlines():
            line = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)       # address
            line = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", line)      # encoding
            line = line.strip()
            if line and not line.startswith(".") and not line.startswith("="):
                lines.append(line)
        out[name] = lines
    return out


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.utils import cuda_build

    other = Path(argv[1]).resolve()
    names = argv[2:] or cuda_build.sources()
    work = cuda_build.BUILD_DIR / "sass_ab"
    roots = {"this": cuda_build.CSRC_DIR, "other": other}
    jobs = {}
    for name in names:
        for side, root in roots.items():
            if (root / f"{name}.cu").exists():
                jobs[(name, side)] = (root / f"{name}.cu", work / side / f"lib{name}.so")
            else:
                print(json.dumps({"source": name, "missing_in": side}), flush=True)
    built = build_all(jobs)
    for name in names:
        if (name, "this") not in built or (name, "other") not in built:
            continue
        sides = {}
        for side in roots:
            lib, log = built[(name, side)]
            regs, code = ptxas(log), sass(lib)
            sides[side] = {key(m): (m, code[m], regs.get(m, {})) for m in code if key(m)}
        this, theirs = sides["this"], sides["other"]
        for k in list(theirs):
            if k not in this:
                # a kernel that lost its only integer argument: its lowest instance
                cands = sorted(x for x in this if x[0] == k[0] and x[2] == k[2] and not k[1])
                if cands:
                    theirs[cands[0]] = theirs.pop(k)
        for k in sorted(set(this) | set(theirs), key=str):
            rec = {"source": name, "kernel": k[0], "args": list(k[1]), "dtype": k[2]}
            if k not in this or k not in theirs:
                rec["unpaired"] = "this" if k in this else "other"
                rec["ptxas"] = (this.get(k) or theirs.get(k))[2]
            else:
                a, b = this[k][1], theirs[k][1]
                diff = [d for d in difflib.unified_diff(b, a, lineterm="", n=0)
                        if d[:1] in "+-" and d[:3] not in ("+++", "---")]
                rec.update(identical=a == b, lines=[len(a), len(b)], differing_lines=len(diff),
                           first_differences=diff[:6], ptxas_this=this[k][2],
                           ptxas_other=theirs[k][2])
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
