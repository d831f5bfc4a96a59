#!/usr/bin/env python3
"""What shapes the time of the bf16 flash backward kernels K2 and K3 (one GPU).

    python3 scripts/flash_bwd_tc_variants.py

Builds ``deeplearning4j_tpu_torch/csrc/flash_bwd_tc.cu`` (the wgmma
kernels) as it is and a few variants of it, each with one choice of its
design turned or one piece of work taken out, then times K2
(``dl4j_flash_bwd_dkdv_tc``) and K3 (``dl4j_flash_bwd_dq_tc``) of every
build on the same inputs: bench config 7's [8, 12, 1024, 64] causal bf16
attention, and [4, 12, 1024, 128].  Variants marked "timing only" compute
wrong gradients on purpose; nothing but this script loads any variant.

  as_built             the source unchanged
  branchy_elementwise  a branch per pair around its exponential and (K2)
                       its lse and delta loads from shared memory, the
                       natural-log form, instead of the exponential in log2
                       units computed for every pair and selected
  k2_four_stages       K2's query ring four stages deep (two blocks an SM
                       at D 64 instead of three)
  k3_three_stages      K3's key ring three stages deep
  no_exp               p = the scaled score itself (timing only)
  no_output_products   dV, dK and dQ products left out (timing only)

Each variant's difference from ``as_built`` bounds what that choice or
piece costs.  Builds go to the gitignored
``deeplearning4j_tpu_torch/_build/tc_variants``.  Prints one JSON line per
variant and shape (device ms per launch, ``device_ms`` of
``chip_smoke.py``, in turns: every variant, then every variant again in
reverse order; ptxas's registers of each kernel), then the card's name and
power limit.  Needs a CUDA device and ``nvcc``; exits non-zero without
them.
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

_K2_SELECT = """        sT[j][r] = live ? p : 0.f;
        dpT[j][r] = live ? ds : 0.f;"""
_K3_SELECT = """        s[j][r] = live ? ds : 0.f;"""

#: variant → [(text in flash_bwd_tc.cu, replacement)]; every text must occur
VARIANTS = {
    "as_built": [],
    "branchy_elementwise": [
        ("""        const float p = fast_exp2(fmaf(sT[j][r], sl2, -((r & 1) ? l2.y : l2.x)));
        const float ds = p * (dpT[j][r] - ((r & 1) ? dl.y : dl.x)) * scale;
""" + _K2_SELECT,
         """        const int col = 8 * j + 2 * t + (r & 1);
        float p = 0.f, ds = 0.f;
        if (live) {
          p = fast_exp(sT[j][r] * scale - Lt[col]);
          ds = p * (dpT[j][r] - Dt[col]) * scale;
        }
        sT[j][r] = p;
        dpT[j][r] = ds;"""),
        ("""        const float p = fast_exp2(fmaf(s[j][r], sl2, -ls2[h]));
        const float ds = p * (dp[j][r] - dl[h]) * scale;
""" + _K3_SELECT,
         """        float ds = 0.f;
        if (live) ds = fast_exp(s[j][r] * scale - ls2[h] / LOG2E) * (dp[j][r] - dl[h]) * scale;
        s[j][r] = ds;""")],
    "k2_four_stages": [("static constexpr int NS2 = 3;", "static constexpr int NS2 = 4;")],
    "k3_three_stages": [("static constexpr int NS3 = 2;", "static constexpr int NS3 = 3;")],
    "no_exp": [("const float p = fast_exp2(fmaf(sT[j][r], sl2, -((r & 1) ? l2.y : l2.x)));",
                "const float p = sT[j][r] * sl2;"),
               ("const float p = fast_exp2(fmaf(s[j][r], sl2, -ls2[h]));",
                "const float p = s[j][r] * sl2;")],
    "no_output_products": [
        ("for (int c = 0; c < BN / 16; ++c) wgmma_rs(adv,", "for (int c = 0; c < 0; ++c) wgmma_rs(adv,"),
        ("for (int c = 0; c < BN / 16; ++c) wgmma_rs(adk,", "for (int c = 0; c < 0; ++c) wgmma_rs(adk,"),
        ("for (int c = 0; c < BN / 16; ++c) wgmma_rs(acc,", "for (int c = 0; c < 0; ++c) wgmma_rs(acc,")],
}


def variant_source(name: str, src: str) -> str:
    """``src`` (the text of flash_bwd_tc.cu) with variant ``name``'s edits;
    raises ValueError where a text to replace is not in it."""
    for old, new in VARIANTS[name]:
        if old not in src:
            raise ValueError(f"flash_bwd_tc_variants: {name}: {old!r} is not in flash_bwd_tc.cu")
        src = src.replace(old, new)
    return src


def build_all():
    """Compile every variant, one ``nvcc`` each, all started together;
    returns name → (library, {kernel: registers})."""
    from deeplearning4j_tpu_torch.utils import cuda_build

    src = (cuda_build.CSRC_DIR / "flash_bwd_tc.cu").read_text()
    out_dir = cuda_build.BUILD_DIR / "tc_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(name, src))
        lib = out_dir / f"lib{name}.so"
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
        regs, kernel = {}, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '\w*?(flash_bwd_\w+?_kernelILi\d+)", line)
            if m:
                kernel = m.group(1).replace("ILi", "<") + ">"
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                regs[kernel], kernel = int(m.group(1)), None
        cdll = ctypes.CDLL(str(lib))
        # pointers, dims, scale, causal, the stream
        tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        dkdv, dq = cdll.dl4j_flash_bwd_dkdv_tc, cdll.dl4j_flash_bwd_dq_tc
        dkdv.restype = dq.restype = ctypes.c_int
        dkdv.argtypes = [ctypes.c_void_p] * 9 + tail
        dq.argtypes = [ctypes.c_void_p] * 8 + tail
        out[name] = (cdll, regs)
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_tc_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import attention as att

    built = build_all()
    for B, D in ((8, cs.D_MODEL // cs.HEADS), (4, 128)):
        H, T = cs.HEADS, cs.MAX_LEN
        rng = np.random.default_rng(cs.SEED + 10)
        q, k, v, g = (torch.from_numpy(rng.standard_normal((B, H, T, D), dtype=np.float32))
                      .to("cuda", torch.bfloat16) for _ in range(4))
        scale = 1.0 / math.sqrt(D)
        o, lse = att.flash_forward_cuda(q, k, v, None, True, scale)
        delta = att.flash_delta(o, g)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        stream = torch.cuda.current_stream().cuda_stream
        ins = [t.data_ptr() for t in (q, k, v, g, lse, delta)] + [None]
        dims = (B, H, T, T, D, scale, 1)

        def launch(fn, *outs):
            def call():
                rc = fn(*ins, *(t.data_ptr() for t in outs), *dims, stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed (code {rc})")
            return call

        times = {name: {"flash_bwd_dkdv_tc": [], "flash_bwd_dq_tc": []} for name in built}
        for name in list(built) + list(reversed(built)):
            lib = built[name][0]
            times[name]["flash_bwd_dkdv_tc"].append(
                cs.device_ms(launch(lib.dl4j_flash_bwd_dkdv_tc, dk, dv), 50))
            times[name]["flash_bwd_dq_tc"].append(cs.device_ms(launch(lib.dl4j_flash_bwd_dq_tc, dq), 50))
        for name, t in times.items():
            print(json.dumps({"variant": name, "shape": [B, H, T, D], "dtype": "bfloat16",
                              "causal": True, "device_ms": t, "registers": built[name][1]}),
                  flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
