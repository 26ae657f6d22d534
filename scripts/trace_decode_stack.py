#!/usr/bin/env python3
"""Phase trace of the persistent decode kernels (csrc/decode_stack.cuh,
csrc/slow_step_rows.cu, csrc/fast_frame_batched.cu) on one NVIDIA GPU.

    python3 scripts/trace_decode_stack.py [--part all|batch1|rows|frame] [--json build/trace.json]

Builds an instrumented copy of the port's kernels on the side (every
csrc/*.cu with -DDS_TRACE, into build/trace_decode_stack/), in which
thread 0 of each block writes %globaltimer at marks of each layer pass,
and runs it in place of the normal library on Fish-1.5 weights (random
bf16 from seed 0, and their int8 quantization): batch1, one fused slow
step at pos 104 of a 4096 cache and one fused fast frame (sampled); rows,
one slow step of the row kernel at each of 16 rows at the serving
positions 39-167 of a 512 cache, 32 rows of a 256 cache and 8 rows at
positions 1024-2047 of a 2048 cache; frame, one batched fast frame (the
persistent kernel of csrc/fast_frame_batched.cu) at 16 and 32 rows with
the serving knobs; each after warm-up calls. For every layer pass it
prints, per mark, the earliest, median and latest block (us after the
pass's first block started), and the pass time; then the medians over the
middle passes. Marks of the batch-1 kernel:

  0 pass start         1 QKV partials done      2 after sync 1
  3 attention done     4 wo partials done       5 after sync 2, x += wo
  6 norm done          7 w1+w3+w2 partials done 8 owners: all arrived
  9 owners: x published 10 after reading x (the pass ends)
  11 head partials done 12 head owners done (slow step); the fast
     frame's sampler launch started (block 0's slot of the step's last
     pass)              13 the sampler launch's end
  16 w1+w3 taken       17 K-split group exchanged  18 w2 taken
  20 draw: logits      21 softmax              22 token (block 0's
     slots of the step's last pass)
  24 attention: q/k/v  25 scores               26 weights
  30, 31 the SM's clock64 at marks 0 and 10
Marks of the row kernel (a block's last unit of each phase):
  0 pass start         1 QKV partials done      2 after sync 1
  3 q/k/v gathered     4 attention done         5 head exchange done
  6 wo partials done   7 owners: all arrived    8 owners: x published
  9 the block saw x published                   19 the block read x
  10 x read and normed (ends (b))               11 w1+w3 partials done
  12 K-split group exchanged                    13 g done
  14 w2 partials done  15 owners: all arrived   16 owners: x published
  18 the block saw x published                  23 the block read x
  17 the pass ends (x read and normed)
  20 head partials done (last pass)  21 after the head's sync  22 logits
  24 attention: the ranks' (max, sum) posted   25 the ranks' PV done
  26, 27, 28, 29 the first ring stage of w1 + w3, w2, QKV, wo arrived
  30, 31 the SM's clock64 at marks 0 and 17
The batched frame's passes cb * L + l are the row kernel's layer marks
(its step cb, layer l); pass C * L + cb holds step cb's head and draw:
  0 the last layer done  1 head partials done   2 after the head's sync
  3 draw: logits gathered and penalised (blocks b < B)
  11 max                 12 sum                  4 probabilities
  13 first radix pass    14 last radix pass      5 top-k compacted
  6 sorted               7 token published       8 after the draw's sync
  9 the next x read
For the frame it also prints each step's phases and the wait at the step
boundary for the first ring stage of the next step's QKV (mark 28 of
pass (cb + 1) * L against mark 0 of it).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PASSES, MARKS, MAX_BLOCKS = 48, 32, 1024


def build_traced() -> ctypes.CDLL:
    from fish_speech_tpu_torch.ops import _cuda_build

    lib = _cuda_build.load_variant("trace_decode_stack", ["DS_TRACE"])
    for name in ("fs_slow_step_trace", "fs_fast_frame_trace", "fs_slow_step_rows_trace",
                 "fs_fast_frame_batched_trace"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def read_trace(lib, entry: str, grid: int):
    n = MAX_BLOCKS * PASSES * MARKS
    buf = (ctypes.c_ulonglong * n)()
    rc = getattr(lib, entry)(ctypes.addressof(buf), n)
    if rc:
        raise RuntimeError(f"{entry}: cudaError {rc}")
    return [[[buf[(b * PASSES + p) * MARKS + k] for k in range(MARKS)] for p in range(PASSES)]
            for b in range(grid)]


def summarize(trace, passes: int, label: str, end_mark: int = 10) -> dict:
    """Per pass and mark: (earliest, median, latest) us after the pass's
    first start, over the blocks that wrote the mark; end_mark: the pass's
    last mark (for the SM clock)."""
    out = {}
    starts = [min(b[p][0] for b in trace) for p in range(passes)]
    for p in range(passes):
        row = {}
        for k in range(MARKS):
            vals = sorted((b[p][k] - starts[p]) / 1e3 for b in trace
                          if b[p][k] >= starts[p] and (p + 1 >= passes or b[p][k] < starts[p + 1]
                                                       or 11 <= k <= 15 or 20 <= k <= 22) and k < 30)
            if vals:
                row[k] = (vals[0], statistics.median(vals), vals[-1], len(vals))
        row["pass_us"] = ((starts[p + 1] - starts[p]) / 1e3) if p + 1 < passes else None
        out[p] = row
    print(f"== {label}: us after the pass's first block started (earliest / median / "
          f"latest block, blocks)")
    mid = list(range(min(4, passes), max(passes - 4, min(4, passes) + 1)))
    for k in range(MARKS):
        vals = [out[p][k] for p in mid if k in out[p]]
        if vals:
            med = [statistics.median(v[i] for v in vals) for i in range(3)]
            print(f"  mark {k:2d}: {med[0]:8.2f} {med[1]:8.2f} {med[2]:8.2f}  ({vals[0][3]} blocks)")
    clk = [(b[p][31] - b[p][30]) / max(b[p][end_mark] - b[p][0], 1) for p in mid for b in trace
           if b[p][31] > b[p][30] and b[p][end_mark] > b[p][0]]
    if clk:
        print(f"  SM clock over a pass (cycles / ns), median of blocks: "
              f"{statistics.median(clk):.3f}")
    last = out[passes - 1]
    if 20 in last:
        print("  the frame's last draw (us after its pass started): "
              + ", ".join(f"mark {k} {last[k][1]:.2f}" for k in (11, 12, 20, 21, 22, 13)
                          if k in last))
    pts = [out[p]["pass_us"] for p in mid if out[p]["pass_us"]]
    if pts:
        print(f"  pass time, middle passes: median {statistics.median(pts):.2f} us "
              f"(min {min(pts):.2f}, max {max(pts):.2f})")
    return {str(p): {str(k): v for k, v in row.items()} for p, row in out.items()}


def trace_batch1(torch, lib, cfg, p, kind, rope, gen, grid) -> dict:
    from fish_speech_tpu_torch.ops import fast_frame as ff
    from fish_speech_tpu_torch.ops import slow_step as ss
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs, gumbel_noise, top_k_width

    dev = torch.device("cuda")
    results = {}
    x0 = torch.randn((1, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.tensor([104], dtype=torch.int32, device=dev)
    shape = (cfg.n_layer, 1, cfg.n_local_heads, cfg.max_seq_len, cfg.head_dim)
    ck = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    cv = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    for _ in range(3):
        ss.fused_slow_step(p, cfg, x0, pos, ck, cv, rope)
    torch.cuda.synchronize()
    ss.fused_slow_step(p, cfg, x0, pos, ck, cv, rope)
    torch.cuda.synchronize()
    tr = read_trace(lib, "fs_slow_step_trace", grid)
    results[f"slow_{kind}"] = summarize(tr, cfg.n_layer, f"slow step {kind}, pos 104")
    samp = SamplingArgs(temp=0.7, top_p=0.8, top_k=256, repetition_penalty=1.4)
    n_cb, vocab = cfg.num_codebooks, cfg.codebook_size
    window = torch.randint(-1, vocab, (n_cb, 16), generator=gen, device=dev, dtype=torch.int32)
    gumbel = gumbel_noise((n_cb, top_k_width(samp.top_k, vocab)), gen, dev)
    eos = torch.tensor([False], device=dev)
    for _ in range(3):
        ff.fused_fast_frame(p, cfg, samp, x0, window, gumbel, eos, rope, rep_enabled=True)
    torch.cuda.synchronize()
    ff.fused_fast_frame(p, cfg, samp, x0, window, gumbel, eos, rope, rep_enabled=True)
    torch.cuda.synchronize()
    tr = read_trace(lib, "fs_fast_frame_trace", grid)
    results[f"fast_{kind}"] = summarize(tr, n_cb * cfg.n_fast_layer, f"fast frame {kind} (sampled)")
    return results


def trace_rows(torch, lib, cfg, p, kind, rope, gen, grid) -> dict:
    from fish_speech_tpu_torch.ops import slow_step as ss

    dev = torch.device("cuda")
    head_rows = ss.padded_head(p["output"])
    out = {}
    for b, cache, lo, hi in ((16, 512, 39, 168), (32, 256, 0, 256), (8, 2048, 1024, 2048)):
        x0 = torch.randn((b, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
        pos = (torch.randperm(hi - lo, generator=gen, device=dev)[:b] + lo).to(torch.int32)
        shape = (cfg.n_layer, b, cfg.n_local_heads, cache, cfg.head_dim)
        ck = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        cv = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        for _ in range(4):
            ss.fused_slow_step(p, cfg, x0, pos, ck, cv, rope, head_rows=head_rows)
        torch.cuda.synchronize()
        tr = read_trace(lib, "fs_slow_step_rows_trace", grid)
        out[f"rows_{kind}_b{b}_cache{cache}"] = summarize(
            tr, cfg.n_layer, f"slow step {kind}, {b} rows, cache {cache}, pos {lo}-{hi - 1} "
            "(row kernel)", end_mark=17)
    return out


def trace_frame(torch, lib, cfg, p, kind, rope, gen, grid) -> dict:
    """The batched frame at 16 and 32 rows: the layer passes as the row
    kernel's, then each step's head and draw (pass C * L + cb) and the
    wait for the next step's first weights."""
    from fish_speech_tpu_torch.ops import fast_frame_batched as fb
    from fish_speech_tpu_torch.ops.sampling import RowSampling, gumbel_noise

    dev = torch.device("cuda")
    n_cb, n_layer, vocab = cfg.num_codebooks, cfg.n_fast_layer, cfg.codebook_size
    out = {}
    for b in (16, 32):
        hidden = torch.randn((b, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
        window = torch.randint(-1, vocab, (b, n_cb, 12), generator=gen, device=dev,
                               dtype=torch.int32)
        gumbel = gumbel_noise((b, n_cb, 256), gen, dev)
        samp = RowSampling.from_vectors(torch.tensor([[0.7, 0.8, 256.0, 1.4]] * b,
                                                     dtype=torch.float32, device=dev))
        eos = torch.zeros((b,), dtype=torch.bool, device=dev)
        for _ in range(4):
            fb.fused_fast_frame_batched(p, cfg, samp, hidden, window, gumbel, eos, rope,
                                        rep_enabled=True)
        torch.cuda.synchronize()
        tr = read_trace(lib, "fs_fast_frame_batched_trace", grid)
        label = f"batched fast frame {kind}, {b} rows"
        layers = n_cb * n_layer
        res = summarize(tr, layers, f"{label}: layer passes", end_mark=17)
        start = min(blk[0][0] for blk in tr)
        steps = []
        for cb in range(n_cb):
            t0 = statistics.median((blk[cb * n_layer][0] - start) / 1e3 for blk in tr)
            row = {}
            for k in range(16):
                vals = sorted((blk[layers + cb][k] - start) / 1e3 - t0 for blk in tr
                              if blk[layers + cb][k] >= start)
                if vals:
                    row[k] = (vals[0], statistics.median(vals), vals[-1], len(vals))
            if cb + 1 < n_cb:
                nxt = (cb + 1) * n_layer
                waits = [(blk[nxt][28] - blk[nxt][0]) / 1e3 for blk in tr
                         if blk[nxt][28] >= blk[nxt][0] > 0]
                if waits:
                    row["ring_wait_us"] = (min(waits), statistics.median(waits), max(waits))
            steps.append(row)
        print(f"== {label}: each step's head and draw, us after the step's first layer "
              "started (median block; the draw's marks over its B blocks)")
        for cb, row in enumerate(steps):
            marks = ", ".join(f"{k} {row[k][1]:.2f}" for k in range(16) if k in row)
            wait = row.get("ring_wait_us")
            print(f"  step {cb}: {marks}" + (f"; the next step's first QKV stage waited "
                                              f"{wait[1]:.2f} us (max {wait[2]:.2f})"
                                              if wait else ""))
        mid = steps[1:-1] or steps
        for a_, b_, what in ((0, 1, "head partials"), (1, 2, "head sync"),
                             (2, 3, "draw: knobs, logits, penalty"), (3, 11, "draw: max"),
                             (11, 12, "draw: sum"),
                             (12, 4, "draw: probabilities"), (4, 13, "draw: first radix pass"),
                             (13, 14, "draw: other radix passes"), (14, 5, "draw: compaction"),
                             (5, 6, "draw: sort"), (6, 7, "draw: scan, token, embedding"),
                             (7, 8, "draw sync"), (8, 9, "next x read")):
            d = [r[b_][1] - r[a_][1] for r in mid if a_ in r and b_ in r]
            if d:
                print(f"  {what}: median {statistics.median(d):.2f} us a step")
        # the first layer after a draw against the next: the drawing blocks
        # (b < B) against the others, per phase (median over steps 1..C-1)
        for lay in (0, 1):
            for what, a_, b_ in (("QKV", 0, 1), ("q/k/v", 2, 3), ("scores", 3, 24),
                                 ("PV", 24, 25), ("wo", 5, 29)):
                grp = {True: [], False: []}
                for cb in range(1, n_cb):
                    pp = cb * n_layer + lay
                    for blk_i, blk in enumerate(tr):
                        if blk[pp][a_] and blk[pp][b_] >= blk[pp][a_]:
                            grp[blk_i < b].append((blk[pp][b_] - blk[pp][a_]) / 1e3)
                if grp[True] and grp[False]:
                    print(f"  layer {lay} {what}: drawing blocks median "
                          f"{statistics.median(grp[True]):.2f} (max {max(grp[True]):.2f}) us, "
                          f"the others {statistics.median(grp[False]):.2f} (max "
                          f"{max(grp[False]):.2f})")
        out[f"frame_{kind}_b{b}"] = {"passes": res, "steps": [
            {str(k): v for k, v in r.items()} for r in steps]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", default="all", choices=("all", "batch1", "rows", "frame"))
    ap.add_argument("--json", default=None, help="write the summaries here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("trace_decode_stack: CUDA is not available", file=sys.stderr)
        return 2
    from fish_speech_tpu_torch.config import DualARConfig
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params, rope_tables
    from fish_speech_tpu_torch.ops import quant

    t0 = time.perf_counter()
    lib = build_traced()
    print(f"instrumented build {time.perf_counter() - t0:.1f}s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    cfg = DualARConfig.fish_speech_1_5()
    dev = torch.device("cuda")
    grid = torch.cuda.get_device_properties(dev).multi_processor_count
    params = init_dual_ar_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    params["output"] = params["output"][:, :cfg.codebook_size + 1].contiguous()
    rope = rope_tables(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {"device": smi.strip()}
    for kind in ("bf16", "int8"):
        p = quant.quantize_lm_params(params) if kind == "int8" else params
        with torch.inference_mode():
            if args.part in ("all", "batch1"):
                results.update(trace_batch1(torch, lib, cfg, p, kind, rope, gen, grid))
            if args.part in ("all", "rows"):
                results.update(trace_rows(torch, lib, cfg, p, kind, rope, gen, grid))
            if args.part in ("all", "frame"):
                results.update(trace_frame(torch, lib, cfg, p, kind, rope, gen, grid))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
