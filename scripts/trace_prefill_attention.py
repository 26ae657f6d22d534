#!/usr/bin/env python3
"""Per-CTA timeline of flash prefill attention (csrc/prefill_attention.cu)
on one NVIDIA GPU.

    python3 scripts/trace_prefill_attention.py [--json build/trace.json]

Builds an instrumented copy of the kernel on the side (`nvcc -shared
-DPA_TRACE` of csrc/prefill_attention.cu alone, into
build/trace_prefill_attention/), in which thread 0 of each CTA records
%globaltimer at its start, when its Q tile arrived, when its first K/V
tile arrived, after its last tile and at its end, with its SM and its
tile count, and calls it through the public wrapper in place of the
normal library. Fish-1.5 heads (16 q heads over 2 KV heads, hd 64),
bf16, random inputs from seed 0, k/v as views of a 4096-entry cache; the
shapes of `scripts/time_prefill_attention.py`. For each shape, after
warm-up calls, one traced call: the span from the first CTA's start to
the last CTA's end, the mean time from a CTA's start to its Q tile and
to its first K/V tile, the time a tile (mean, min, max over CTAs), the
epilogue (after the last tile to the end), the tiles a SM took (mean and
max) and its span; then the three CTAs that ended last. Times in us.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from time_prefill_attention import SHAPES  # noqa: E402


def build_traced(cb) -> ctypes.CDLL:
    out = ROOT / "build" / "trace_prefill_attention"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libpa_trace.so"
    cmd = [cb.find_nvcc(), *cb.NVCC_FLAGS[:-2], "-DPA_TRACE", "-shared", "-o", str(lib_path),
           str(cb.CSRC / "prefill_attention.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for name in ("fs_prefill_attention", "fs_prefill_plan"):
        fn = getattr(lib, name)
        fn.argtypes = cb.SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.fs_prefill_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fs_prefill_trace.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None, help="write the summaries here")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("trace_prefill_attention: CUDA is not available", file=sys.stderr)
        return 2
    from fish_speech_tpu_torch.ops import _cuda_build
    from fish_speech_tpu_torch.ops import prefill_attention as pa

    lib = build_traced(_cuda_build)
    _cuda_build._lib = lib  # the wrapper launches the traced kernel
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"trace_prefill_attention: {smi}", flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    h, kv, hd, cache, window = 16, 2, 64, 4096, 4096
    out = {"device": smi}
    for label, s_pad, e, offset, n in SHAPES:
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
        q, ck, cv = rnd(1, h, s_pad, hd), rnd(1, kv, cache, hd), rnd(1, kv, cache, hd)
        k, v = ck[:, :, :e], cv[:, :, :e]
        sl = torch.tensor([n], dtype=torch.int32, device=dev)
        for _ in range(3):
            pa.prefill_attention(q, k, v, offset, sl, window)
        torch.cuda.synchronize()
        ctas = pa.prefill_plan(s_pad, e, h, kv, sms).ctas
        rec = np.zeros(ctas * 8, np.uint64)
        _cuda_build.check(lib.fs_prefill_trace(rec.ctypes.data, ctas), "fs_prefill_trace")
        pa.prefill_attention(q, k, v, offset, sl, window)
        torch.cuda.synchronize()
        _cuda_build.check(lib.fs_prefill_trace(rec.ctypes.data, ctas), "fs_prefill_trace")
        r = rec.reshape(ctas, 8).astype(np.int64)
        r = r[(r[:, 4] > 0) & (r[:, 6] > 0)]  # CTAs that walked tiles
        t0 = r[:, 0].min()
        start, q_in, first, last, end = ((r[:, i] - t0) / 1e3 for i in range(5))
        sm, tiles = r[:, 5], r[:, 6]
        per_tile = (last - first) / tiles
        per_sm = [(tiles[sm == x].sum(), end[sm == x].max() - start[sm == x].min())
                  for x in np.unique(sm)]
        sm_tiles = np.array([t for t, _ in per_sm])
        sm_span = np.array([s for _, s in per_sm])
        summary = {
            "ctas": int(len(r)), "span_us": float(end.max()),
            "to_q_us": float((q_in - start).mean()), "to_first_tile_us": float((first - start).mean()),
            "tile_us": [float(per_tile.mean()), float(per_tile.min()), float(per_tile.max())],
            "epilogue_us": float((end - last).mean()),
            "sm_tiles": [float(sm_tiles.mean()), int(sm_tiles.max())],
            "sm_span_us": [float(sm_span.mean()), float(sm_span.max())],
        }
        out[label] = summary
        print(f"trace_prefill_attention {label}: {summary['ctas']} CTAs with tiles, span "
              f"{summary['span_us']:.2f} us; start to Q {summary['to_q_us']:.2f}, to the first "
              f"tile {summary['to_first_tile_us']:.2f}; a tile {per_tile.mean():.3f} (min "
              f"{per_tile.min():.3f}, max {per_tile.max():.3f}); epilogue "
              f"{summary['epilogue_us']:.2f}; tiles a SM {sm_tiles.mean():.1f} (max "
              f"{sm_tiles.max()}), SM span {sm_span.mean():.2f} (max {sm_span.max():.2f})",
              flush=True)
        for i in np.argsort(-end)[:3]:
            print(f"    ended last: start {start[i]:.2f}, Q {q_in[i]:.2f}, first tile "
                  f"{first[i]:.2f}, last tile {last[i]:.2f}, end {end[i]:.2f}, SM {sm[i]}, "
                  f"{tiles[i]} tiles", flush=True)
    print(json.dumps(out), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
