#!/usr/bin/env python3
"""What shapes the time of the bf16 flash forward kernel K1 (one GPU).

    python3 scripts/flash_fwd_tc_variants.py

Builds ``deeplearning4j_tpu_torch/csrc/flash_fwd_tc.cu`` (the wgmma kernel)
as it is and a few variants of it, each with one choice of its design
turned or one piece of work taken out, then times ``dl4j_flash_fwd_tc`` of
every build on the same inputs: bench config 7's [8, 12, 1024, 64] causal
bf16 attention, and [4, 12, 1024, 128].  Variants marked "timing only"
compute a wrong O on purpose; nothing but this script loads any variant.

  as_built      the source unchanged
  no_overlap    the next tile's softmax waits for this tile's P.V too
                (wait<0> for wait<1>): the products and the exponentials of
                one warpgroup take turns
  ping_pong     two consumer warpgroups a block (128 queries) on one K/V
                ring
  three_stages  the K and V rings three slots deep
  light_first   the grid walks the lightest causal query tiles first
  interleaved   the grid alternates the heaviest and the lightest tiles
  no_exp        p = the scaled score less the max, no exponential (timing
                only)
  no_pv         the O += P.V products left out (timing only)
  no_softmax    p = the raw score: no max, exponential, mask or sum
                (timing only)
  no_kv_loads   only the first NS key tiles are loaded; later tiles reuse
                their slots (timing only)
  no_mma        neither S = Q.K^T nor O += P.V is issued (timing only)
  skeleton      no_kv_loads, no_softmax and no_mma at once: the loads of Q
                and the first tiles, the loop's waits and barriers, the
                epilogue (timing only)

Each variant's difference from ``as_built`` bounds what that choice or
piece costs.  Builds go to the gitignored
``deeplearning4j_tpu_torch/_build/tc_variants``.  Prints one JSON line per
variant and shape (device ms per launch, ``device_ms`` of
``chip_smoke.py``, in turns: every variant, then every variant again in
reverse order; ptxas's registers and spill bytes of each kernel, and any
line in which ptxas says it serialised the wgmma pipeline), SDPA's device
ms on the same inputs, then the card's name and power limit.  Needs a CUDA
device and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_Q0 = "const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;"

#: variant → [(text in flash_fwd_tc.cu, replacement)]; every text must occur
VARIANTS = {
    "as_built": [],
    "no_overlap": [("wgmma_wait<1>();", "wgmma_wait<0>();")],
    "ping_pong": [("static constexpr int WG = 1;", "static constexpr int WG = 2;")],
    "three_stages": [("static constexpr int NS = 2;", "static constexpr int NS = 3;")],
    "no_exp": [("float p = fast_exp2(fmaf(s[jj][r], sl2, msc[r >> 1]));",
                "float p = fmaf(s[jj][r], sl2, msc[r >> 1]);")],
    "no_pv": [("for (int c = 0; c < BN / 16; ++c) wgmma_rs(acc,",
               "for (int c = 0; c < 0; ++c) wgmma_rs(acc,")],
    "light_first": [(_Q0, "const int q0 = blockIdx.y * BQ;")],
    "interleaved": [(_Q0, "const int q0 = ((blockIdx.y & 1) ? blockIdx.y / 2 "
                          ": gridDim.y - 1 - blockIdx.y / 2) * BQ;")],
    "no_softmax": [("auto softmax = [&](int j, auto pos) {",
                    "auto softmax = [&](int j, auto pos) { return;")],
    "no_kv_loads": [
        ("if (i + 1 + NS < n) issue_k(i + 1 + NS);", ""),
        ("if (i + NS < n) issue_v(i + NS);", ""),
        ("if (NS < n) issue_k(NS);", ""),
        ("mbar_wait(&kbar[(i + 1) % NS], ((i + 1) / NS) & 1);",
         "if (i + 1 < NS) mbar_wait(&kbar[(i + 1) % NS], ((i + 1) / NS) & 1);"),
        ("mbar_wait(&vbar[i % NS], (i / NS) & 1);",
         "if (i < NS) mbar_wait(&vbar[i % NS], (i / NS) & 1);"),
        ("mbar_wait(&vbar[(n - 1) % NS], ((n - 1) / NS) & 1);",
         "if (n - 1 < NS) mbar_wait(&vbar[(n - 1) % NS], ((n - 1) / NS) & 1);")],
    "no_mma": [("for (int c = 0; c < KC; ++c) wgmma_ss(", "for (int c = 0; c < 0; ++c) wgmma_ss("),
               ("for (int c = 0; c < BN / 16; ++c) wgmma_rs(acc,",
                "for (int c = 0; c < 0; ++c) wgmma_rs(acc,")],
}
VARIANTS["skeleton"] = VARIANTS["no_kv_loads"] + VARIANTS["no_softmax"] + VARIANTS["no_mma"]


def variant_source(name: str, src: str) -> str:
    """``src`` (the text of flash_fwd_tc.cu) with variant ``name``'s edits;
    raises ValueError where a text to replace is not in it."""
    for old, new in VARIANTS[name]:
        if old not in src:
            raise ValueError(f"flash_fwd_tc_variants: {name}: {old!r} is not in flash_fwd_tc.cu")
        src = src.replace(old, new)
    return src


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each K1 kernel in ``nvcc -Xptxas -v``'s
    output, and ptxas's lines about the wgmma pipeline."""
    kernels, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?\w*?"
                      r"(flash_fwd_wgmma_kernelILi\d+)", line)
        if m:
            kernel = m.group(1).replace("ILi", "<") + ">"
            kernels.setdefault(kernel, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernel:
            kernels[kernel]["spill_stores"] = int(m.group(1))
            kernels[kernel]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            kernels[kernel]["registers"] = int(m.group(1))
    notes = [line.strip() for line in log.splitlines()
             if "wgmma.mma_async" in line or "serializ" in line.lower()]
    return {"kernels": kernels, "wgmma_notes": notes}


def build_all():
    """Compile every variant, one ``nvcc`` each, all started together;
    returns name → (library, ptxas report)."""
    from deeplearning4j_tpu_torch.utils import cuda_build

    src = (cuda_build.CSRC_DIR / "flash_fwd_tc.cu").read_text()
    out_dir = cuda_build.BUILD_DIR / "tc_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        cu = out_dir / f"fwd_{name}.cu"
        cu.write_text(variant_source(name, src))
        lib = out_dir / f"libfwd_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-I", str(cuda_build.CSRC_DIR), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    out = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        log = log.decode(errors="replace")
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        fn = cdll.dl4j_flash_fwd_tc
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        out[name] = (fn, ptxas_report(log))
    return out


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_fwd_tc_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    built = build_all()
    for B, D in ((8, cs.D_MODEL // cs.HEADS), (4, 128)):
        H, T = cs.HEADS, cs.MAX_LEN
        rng = np.random.default_rng(cs.SEED)
        q, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, D), dtype=np.float32))
                   .to("cuda", torch.bfloat16) for _ in range(3))
        scale = 1.0 / math.sqrt(D)
        o = torch.empty_like(q)
        lse = torch.empty((B, H, T), dtype=torch.float32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def launch(fn):
            def call():
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(),
                        lse.data_ptr(), B, H, T, T, D, scale, 1, stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed (code {rc})")
            return call

        times = {name: [] for name in built}
        for name in list(built) + list(reversed(built)):
            times[name].append(cs.device_ms(launch(built[name][0]), 50))
        sdpa = cs.device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 50)
        for name, t in times.items():
            print(json.dumps({"variant": name, "shape": [B, H, T, D], "dtype": "bfloat16",
                              "causal": True, "device_ms": t, "sdpa_device_ms": sdpa,
                              "ptxas": built[name][1]}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
