#!/usr/bin/env python3
"""Variants of kernels K5a (LSTM forward over a sequence), K5b (LSTM cell
backward) and K6 (threshold encode), timed against the kernels as built
(one GPU).

    python3 scripts/k5b_k6_variants.py

Builds ``csrc/lstm_cell.cu`` and ``csrc/threshold_encode.cu`` as they are
and a few variants of each, made by editing the source as text, then
times every build through the port's own wrappers (its library swapped
in for the built one) on the main path's shapes:

  lstm_cell  as_built          K5b: 64-thread blocks, one unit a thread
             block_32          K5b: 32-thread blocks
             block_128         K5b: 128-thread blocks
             fence_barrier     K5a: the grid barrier with full fences
                               (__threadfence around an atomicAdd), not a
                               release add and acquire loads
             scalar_h_staging  K5a: h staged one element a load
             tile_8_rows       K5a: tiles of 8 rows (256 blocks at [64, 256])
             tile_4_units      K5a: tiles of 4 units (256 blocks at [64, 256])
             no_grid_barrier   timing only: K5a with no barrier between steps
             no_product        timing only: K5a with no h·RW product
    K5b at the char-RNN's [64, 256] in f32 and bf16, and [4096, 256] f32;
    K5a at the chunk's [64, 50, 256] in f32 and bf16 and the stream's
    [1, 1, 256];
  threshold_encode  as_built
             one_tile_segments  every segment one tile (no streaming: a
                                block for each tile, as for a small launch)
             four_tile_segments every segment 4 tiles
             four_blocks_per_sm __launch_bounds__ asks for 4 blocks an SM
                                (the compiler caps the registers to fit)
             cached_loads       the gradient read through the read-only
                                cache (__ldg) instead of evict-first (__ldcs)
             release_acquire_status  the status words stored with release
                                and loaded with acquire, not relaxed
             block_index_segments  a block's segment is its block index, not
                                a ticket (no atomic; in-order start assumed)
             no_look_back       timing only: no look-back (every prefix 0)
             no_scatter         timing only: no selection stored
             no_tail_zeros      timing only: no message tail zeroed
    over the compressed phase's 156 buckets and on one 4 MiB bucket
    (2%-hot gradients drawn on the card from a seed).

Every variant but the timing-only ones computes the same function; each
result is checked against the plain version (K6 bitwise, K5b within 2e-6
in f32 and one bf16 spacing, K5a as ``chip_smoke.py`` holds it).  Builds go to the gitignored ``deeplearning4j_tpu_torch/_build/
variants``.  Prints one JSON line per kernel, variant and shape (device
ms per launch, ``device_ms`` of ``chip_smoke.py``, in turns: every
variant, then every variant again in reverse order), then the card's
name and power limit.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: source → variant → [(text in the source, replacement)]; every text must occur
VARIANTS = {
    "lstm_cell": {
        "as_built": [],
        "block_32": [("constexpr int kBwdThreads = 64;", "constexpr int kBwdThreads = 32;")],
        "block_128": [("constexpr int kBwdThreads = 64;", "constexpr int kBwdThreads = 128;")],
        "fence_barrier": [(
            '    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(arrived), '
            '"r"(1u) : "memory");\n    while (load_acquire(arrived) < target) {\n    }\n',
            "    __threadfence();\n    atomicAdd(arrived, 1u);\n"
            "    while (load_acquire(arrived) < target) {\n    }\n    __threadfence();\n")],
        "scalar_h_staging": [("  if (a.vec) {  // 16-byte rows", "  if (false) {  // 16-byte rows")],
        "tile_8_rows": [("constexpr int kTileRows = 16;", "constexpr int kTileRows = 8;"),
                        ("constexpr int kRowsPerThread = 4;", "constexpr int kRowsPerThread = 2;")],
        "tile_4_units": [("constexpr int kTileUnits = 8;", "constexpr int kTileUnits = 4;"),
                         ("constexpr int kRowsPerThread = 4;", "constexpr int kRowsPerThread = 2;")],
        "no_grid_barrier": [("if (s + 1 < a.T) grid_barrier(", "if (s < 0) grid_barrier(")],
        "no_product": [("for (int k = 4 * ks; k < klen; k += kKPad) {",
                        "for (int k = 4 * ks; k < 0; k += kKPad) {")],
    },
    "threshold_encode": {
        "as_built": [],
        "one_tile_segments": [],
        "four_tile_segments": [],
        "four_blocks_per_sm": [("__global__ void __launch_bounds__(kThreads)\n"
                                "threshold_encode_kernel",
                                "__global__ void __launch_bounds__(kThreads, 4)\n"
                                "threshold_encode_kernel")],
        "cached_loads": [("__ldcs(", "__ldg(")],
        "release_acquire_status": [("st.relaxed.gpu.b64", "st.release.gpu.b64"),
                                   ("ld.relaxed.gpu.b64", "ld.acquire.gpu.b64")],
        "block_index_segments": [("s_seg = (int)atomicAdd(ticket, 1u);",
                                  "s_seg = (int)blockIdx.x;")],
        "no_look_back": [("do {\n            s = load_relaxed(status + idx);\n"
                          "          } while ((s >> 32) == 0);", "s = kPrefix;")],
        "no_scatter": [("if (slot < bk.k) msg[slot] =", "if (slot < 0) msg[slot] =")],
        "no_tail_zeros": [("if (count < bk.k) zero_block(", "if (count < 0) zero_block(")],
    },
}
#: variants that leave out a piece of work: wrong messages on purpose, timed
#: only, to price that piece
TIMING_ONLY = {("threshold_encode", "no_look_back"), ("threshold_encode", "no_scatter"),
               ("threshold_encode", "no_tail_zeros"), ("lstm_cell", "no_grid_barrier"),
               ("lstm_cell", "no_product")}
#: variants that change what the wrapper launches, not the source: the
#: segment length (tiles a block streams) they force
SEG_TILES = {("threshold_encode", "one_tile_segments"): 1,
             ("threshold_encode", "four_tile_segments"): 4}


def variant_source(source: str, name: str, src: str) -> str:
    """``src`` (the text of csrc/<source>.cu) with variant ``name``'s
    edits; raises ValueError where a text to replace is not in it."""
    for old, new in VARIANTS[source][name]:
        if old not in src:
            raise ValueError(f"k5b_k6_variants: {source}/{name}: {old!r} is not in the source")
        src = src.replace(old, new)
    return src


def build_all():
    """Compile every variant, one ``nvcc`` each, all started together →
    {(source, variant): CDLL}."""
    from deeplearning4j_tpu_torch.utils import cuda_build

    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source, variants in VARIANTS.items():
        src = (cuda_build.CSRC_DIR / f"{source}.cu").read_text()
        for name in variants:
            cu = out_dir / f"{source}_{name}.cu"
            cu.write_text(variant_source(source, name, src))
            lib = out_dir / f"lib{source}_{name}.so"
            procs[source, name] = (lib, subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC_DIR),
                 "-o", str(lib), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for key, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{log.decode(errors='replace')}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k5b_k6_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import compression as comp
    from deeplearning4j_tpu_torch.ops import lstm_kernel as lk

    libs = build_all()
    dev = torch.device("cuda")
    fns = {"lstm_cell": lk._fns, "threshold_encode": comp._encode_fn}
    built = {k: f() for k, f in fns.items()}
    seg_tiles = comp._seg_tiles

    def use(source, name):
        """The wrappers call variant ``name`` of ``source`` from now on."""
        lib = libs[source, name]
        if source == "lstm_cell":
            fwd, bwd = lib.dl4j_lstm_seq_fwd, lib.dl4j_lstm_cell_bwd
            for fn, ref in zip((fwd, bwd), built[source]):
                fn.restype, fn.argtypes = ref.restype, ref.argtypes
            lk._fns = lambda: (fwd, bwd)
        else:
            fn = lib.dl4j_threshold_encode
            fn.restype, fn.argtypes = built[source].restype, built[source].argtypes
            comp._encode_fn = lambda: fn
            forced = SEG_TILES.get((source, name))
            comp._seg_tiles = seg_tiles if forced is None else lambda tiles, sms: forced

    cases = []                            # (source, case, call, check)
    for mb, n, dt in ((cs.RNN_B, cs.RNN_HIDDEN, torch.float32),
                      (cs.RNN_B, cs.RNN_HIDDEN, torch.bfloat16),
                      (4096, cs.RNN_HIDDEN, torch.float32)):
        rng = np.random.default_rng(mb + n)
        ins = [torch.from_numpy(sd * rng.standard_normal(shape, dtype=np.float32)).to(dev, dt)
               for shape, sd in (((mb, 4 * n), 1.0), ((mb, n), 0.5), ((mb, n), 0.1),
                                 ((mb, n), 0.1))]
        want = lk.lstm_cell_bwd_plain(*(x.float() for x in ins))

        def check(ins=ins, want=want, dt=dt):
            got = lk.lstm_cell_bwd_cuda(*ins)
            err = [(a.float() - w).abs() for a, w in zip(got, want)]
            if dt == torch.float32:
                return max(float(e.max()) for e in err) <= 2e-6
            return all(bool((e <= 2.0 ** -7 * w.abs() + 1e-6).all()) for e, w in zip(err, want))

        cases.append(("lstm_cell", f"bwd_{mb}x{n}_{str(dt)[6:]}",
                      lambda ins=ins: lk.lstm_cell_bwd_cuda(*ins), check))
    for mb, t_len, n, dt in ((cs.RNN_B, cs.RNN_TBPTT, cs.RNN_HIDDEN, torch.float32),
                             (cs.RNN_B, cs.RNN_TBPTT, cs.RNN_HIDDEN, torch.bfloat16),
                             (1, 1, cs.RNN_HIDDEN, torch.float32)):
        ins, _ = cs.lstm_seq_inputs(mb, t_len, n, dt, mb + t_len + n)
        want = lk.lstm_seq_fwd_plain(*(x.float() for x in ins))

        def check(ins=ins, want=want, dt=dt):
            got = lk.lstm_seq_fwd_cuda(*ins)
            atol, rtol = (2e-5, 1e-5) if dt == torch.float32 else (2e-2, 1e-2)
            for a, w in zip(got, want):
                d = (a.float() - w).abs()
                limit = atol if dt == torch.float32 else torch.clamp(2.0 ** -7 * w.abs(), min=atol)
                if not bool((d <= limit).all()) or float(d.norm()) > rtol * float(w.norm()):
                    return False
            return True

        cases.append(("lstm_cell", f"seq_fwd_{mb}x{t_len}x{n}_{str(dt)[6:]}",
                      lambda ins=ins: lk.lstm_seq_fwd_cuda(*ins), check))
    t = cs.COMPRESS_T
    for case, sizes in (("encode_step", cs.DP_BUCKET_SIZES), ("encode_4MiB", [1 << 20])):
        g = cs.step_gradient(sizes, t)
        ks = [comp.default_k_max(m) for m in sizes]
        want = comp.threshold_encode_buckets_plain(g, sizes, ks, t)

        def check(g=g, sizes=sizes, ks=ks, want=want):
            got = comp.threshold_encode_buckets_cuda(g, sizes, ks, t)
            return all(bool(torch.equal(a, b)) for a, b in zip(got, want))

        cases.append(("threshold_encode", case,
                      lambda g=g, sizes=sizes, ks=ks:
                      comp.threshold_encode_buckets_cuda(g, sizes, ks, t), check))

    order = [(s, v) for s in VARIANTS for v in VARIANTS[s]]
    times = {(s, c, v): [] for s, c, _, _ in cases for v in VARIANTS[s]}
    ok = {}
    for source, name in order + order[::-1]:
        use(source, name)
        for s, case, call, check in cases:
            if s != source:
                continue
            if (source, name) not in TIMING_ONLY:
                ok[source, case, name] = ok.get((source, case, name), True) and check()
            times[source, case, name].append(cs.device_ms(call))
    for (source, case, name), ms in times.items():
        print(json.dumps({"kernel": source, "case": case, "variant": name, "device_ms": ms,
                          "matches_plain": ok.get((source, case, name))}), flush=True)
    print(cs.card_line(), flush=True)
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
