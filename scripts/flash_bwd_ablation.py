#!/usr/bin/env python3
"""Where the flash backward kernels K2 and K3 spend their time (one GPU).

    python3 scripts/flash_bwd_ablation.py

Builds ``deeplearning4j_tpu_torch/csrc/flash_bwd.cu`` as it is and a few
variants of it, each with one piece of work taken out or one resource
changed, then times K2 (``dl4j_flash_bwd_dkdv``) and K3
(``dl4j_flash_bwd_dq``) of every build on the same inputs: the train
phase's [8, 12, 1024, 64] causal f32 attention from ``chip_smoke.py``.
The variants compute wrong gradients on purpose; they exist only to be
timed, and nothing else loads them.

  as_built            the source unchanged
  two_blocks_per_sm   35,000 bytes more shared memory a block, so that two
                      blocks share an SM instead of three (same code)
  half_row_loads      the score products load each thread's resident-row
                      operand every other d step (half those shared loads)
  half_col_loads      the same for the streamed-row operand
  no_exp              p = s * scale - lse instead of its exponential
  no_dp_product       dp a constant: one score-sized product fewer
  no_output_products  the output products (K2: dV and dK, K3: dQ) left out

Each variant's difference from ``as_built`` bounds what that piece costs.
Builds go to the gitignored ``deeplearning4j_tpu_torch/_build/ablation``.
Prints one JSON line per variant (device ms per launch, ``device_ms`` of
``chip_smoke.py``, in turns: every variant, then every variant again in
reverse order), then the card's name and power limit.  Needs a CUDA
device and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: variant → [(text in flash_bwd.cu, replacement)]; every text must occur
VARIANTS = {
    "as_built": [],
    "two_blocks_per_sm": [("(DKDV ? 2 * BM * PS + 2 * BN : BM * PS) * sizeof(float);",
                           "(DKDV ? 2 * BM * PS + 2 * BN : BM * PS) * sizeof(float) + 35000;")],
    "half_row_loads": [("a[i] = ld4(A + (ty + 16 * i) * SP + c);",
                        "a[i] = ld4(A + (ty + 16 * i) * SP + (c & ~7));")],
    "half_col_loads": [("b[j] = ld4(B + (tx + 8 * j) * SP + c);",
                        "b[j] = ld4(B + (tx + 8 * j) * SP + (c & ~7));")],
    "no_exp": [("fast_exp(", "(")],
    "no_dp_product": [
        ("dot_tile<T, DP>(dp, Vs, Gs, ty, tx);",
         "for (int i = 0; i < 4; ++i) for (int j = 0; j < KJ; ++j) dp[i][j] = 0.5f;"),
        ("dot_tile<T, DP>(dp, Gs, Vs, ty, tx);",
         "for (int i = 0; i < 4; ++i) for (int j = 0; j < KJ; ++j) dp[i][j] = 0.5f;")],
    "no_output_products": [
        ("acc_tile<T, DP>(adv, Ps, Gs, ty, tx);", "adv[0][0] += Ps[ty * PS + tx];"),
        ("acc_tile<T, DP>(adk, Dss, Qs, ty, tx);", "adk[0][0] += Dss[ty * PS + tx];"),
        ("acc_tile<T, DP>(acc, Ds, Ks, ty, tx);", "acc[0][0] += Ds[ty * PS + tx];")],
}


def variant_source(name: str, src: str) -> str:
    """``src`` (the text of flash_bwd.cu) with variant ``name``'s edits;
    raises ValueError where a text to replace is not in it."""
    for old, new in VARIANTS[name]:
        if old not in src:
            raise ValueError(f"flash_bwd_ablation: {name}: {old!r} is not in flash_bwd.cu")
        src = src.replace(old, new)
    return src


def build_all():
    """Compile every variant, one ``nvcc`` each, all started together."""
    from deeplearning4j_tpu_torch.utils import cuda_build

    src = (cuda_build.CSRC_DIR / "flash_bwd.cu").read_text()
    out_dir = cuda_build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(name, src))
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC_DIR),
             "-o", str(lib), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log.decode(errors='replace')}")
        libs[name] = ctypes.CDLL(str(lib))
        # pointers, dims, scale, causal, the stream
        tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        dkdv, dq = libs[name].dl4j_flash_bwd_dkdv, libs[name].dl4j_flash_bwd_dq
        dkdv.restype = dq.restype = ctypes.c_int
        dkdv.argtypes = [ctypes.c_void_p] * 9 + tail
        dq.argtypes = [ctypes.c_void_p] * 8 + tail
    return libs


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import attention as att

    libs = build_all()
    B, H, T, D = 8, cs.HEADS, cs.MAX_LEN, cs.D_MODEL // cs.HEADS
    rng = np.random.default_rng(cs.SEED + 10)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, H, T, D), dtype=np.float32)).cuda()
                  for _ in range(4))
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

    times = {name: {"flash_bwd_dkdv": [], "flash_bwd_dq": []} for name in libs}
    for name in list(libs) + list(reversed(libs)):
        lib = libs[name]
        times[name]["flash_bwd_dkdv"].append(cs.device_ms(launch(lib.dl4j_flash_bwd_dkdv, dk, dv), 50))
        times[name]["flash_bwd_dq"].append(
            cs.device_ms(launch(lib.dl4j_flash_bwd_dq, dq), 50))
    for name, t in times.items():
        print(json.dumps({"variant": name, "shape": [B, H, T, D], "dtype": "float32",
                          "causal": True, "device_ms": t}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
