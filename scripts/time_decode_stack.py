#!/usr/bin/env python3
"""Device times of the fused slow step (batch 1 and 5 rows and more), the
fused batch-1 fast frame and the batched fast frame on one NVIDIA GPU.

    python3 scripts/time_decode_stack.py [--part all|batch1|rows|frame] [--json build/times.json]
                                         [--outputs build/rows.pt]
    python3 scripts/time_decode_stack.py --compare build/rows_a.pt build/rows_b.pt

Random Fish-1.5 weights from seed 0 (bf16, and their int8 quantization)
with the gathered slow head (codebook + 1 columns). Times, each the mean
of one call over a CUDA graph of back-to-back calls (`chip_smoke.py`'s
`device_ms`, inputs warm in L2):
  batch1: the slow step at batch 1 at positions 104, 255, 256, 512, 1024,
          2048 and 4095 of a 4096-entry cache, and one sampled fast frame
          (temp 0.7, top_p 0.8, top_k 256, rep-pen 1.4 over a 16-entry
          window), then the eager call of the fast frame;
  rows:   the slow step at 5 rows and more, with the engine's padded
          head: 16 rows of a 512-entry cache at serving positions 39-167,
          32 and 64 rows of a 256-entry cache, 8 rows of a 2048-entry
          cache at positions 1024-2047, each beside its byte bound
          (`chip_smoke.py`'s `rows_bound`);
  frame:  the batched fast frame (`fused_fast_frame_batched`, dynamic
          sampling at the serving knobs: temp 0.7, top_p 0.8, top_k 256,
          rep-pen 1.4 over a 12-entry window, k_dyn 256) at 4, 16 and 32
          rows.
It calls only the wrappers' public functions, so it times whatever kernels sit behind them: to
compare two commits on one card, unpack the other commit (`git archive`)
into a git-ignored directory, copy this script into its `scripts/`, and
run both in one call, in turns. --outputs saves the rows part's outputs
(each shape's logits and hidden, a digest of its caches after the step)
and --compare holds two such files bit-equal, so the same run shows
whether a change to the row kernel kept its bits.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

POSITIONS = (104, 255, 256, 512, 1024, 2048, 4095)
# (rows, cache, positions) of the steps at 5 rows and more
ROWS = (
    (16, 512, [39 + (37 * i) % 129 for i in range(16)]),
    (32, 256, [(37 * i + 5) % 256 for i in range(31)] + [255]),
    (64, 256, [(53 * i + 11) % 256 for i in range(63)] + [255]),
    (8, 2048, [1024, 1031, 1200, 1500, 1777, 2000, 2046, 2047]),
)
FRAME_ROWS = (4, 16, 32)  # rows of the batched fast frame


def time_batch1(torch, cs, cfg, p, kind, rope, gen, samp, label) -> dict:
    from fish_speech_tpu_torch.ops import fast_frame as ff
    from fish_speech_tpu_torch.ops import slow_step as ss
    from fish_speech_tpu_torch.ops.sampling import gumbel_noise, top_k_width

    dev = torch.device("cuda")
    n_cb, vocab = cfg.num_codebooks, cfg.codebook_size
    out = {}
    x0 = torch.randn((1, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    shape = (cfg.n_layer, 1, cfg.n_local_heads, cfg.max_seq_len, cfg.head_dim)
    ck = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    cv = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    for pos_i in POSITIONS:
        pos = torch.tensor([pos_i], dtype=torch.int32, device=dev)
        ms = cs.device_ms(torch, lambda: ss.fused_slow_step(p, cfg, x0, pos, ck, cv, rope),
                          calls=20, replays=5)
        out[f"slow_{kind}_pos{pos_i}"] = ms
        print(f"{label}: slow step {kind} B=1 pos={pos_i}: {ms:.4f} ms", flush=True)
    window = torch.randint(-1, vocab, (n_cb, 16), generator=gen, device=dev, dtype=torch.int32)
    gumbel = gumbel_noise((n_cb, top_k_width(samp.top_k, vocab)), gen, dev)
    eos = torch.tensor([False], device=dev)
    frame = lambda: ff.fused_fast_frame(p, cfg, samp, x0, window, gumbel, eos, rope,  # noqa: E731
                                        rep_enabled=True)
    ms = cs.device_ms(torch, frame, calls=10, replays=5)
    call_ms = cs.eager_ms(torch, frame, 20)
    out[f"fast_{kind}"] = ms
    out[f"fast_{kind}_eager"] = call_ms
    print(f"{label}: fast frame {kind} (sampled): {ms:.4f} ms (eager call {call_ms:.4f} ms)",
          flush=True)
    return out


def time_rows(torch, cs, cfg, p, kind, rope, gen, label, outputs=None) -> dict:
    from fish_speech_tpu_torch.ops import slow_step as ss

    dev = torch.device("cuda")
    head_rows = ss.padded_head(p["output"])
    out = {}
    for b, cache, positions in ROWS:
        x0 = torch.randn((b, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
        shape = (cfg.n_layer, b, cfg.n_local_heads, cache, cfg.head_dim)
        ck = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        cv = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        ms = cs.device_ms(torch, lambda: ss.fused_slow_step(p, cfg, x0, pos, ck, cv, rope,
                                                            head_rows=head_rows),
                          calls=5, replays=4)
        bound_ms = cs.rows_bound(cfg, kind == "int8", p["output"].shape[1], positions)[0]
        out[f"rows_{kind}_b{b}_cache{cache}"] = ms
        if outputs is not None:
            k, v = ck.clone(), cv.clone()
            logits, hidden = ss.fused_slow_step(p, cfg, x0, pos, k, v, rope, head_rows=head_rows)
            digest = hashlib.sha256()
            for t in (k, v):
                digest.update(t.view(torch.int16).cpu().numpy().tobytes())
            outputs[f"rows_{kind}_b{b}_cache{cache}"] = (logits.cpu(), hidden.cpu(),
                                                         digest.hexdigest())
        print(f"{label}: slow step {kind} B={b} cache {cache} pos {min(positions)}-"
              f"{max(positions)}: {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({100 * bound_ms / ms:.1f}% of it)", flush=True)
    return out


def time_frame(torch, cs, cfg, p, kind, rope, gen, label) -> dict:
    from fish_speech_tpu_torch.ops import fast_frame_batched as fb
    from fish_speech_tpu_torch.ops.sampling import RowSampling, gumbel_noise

    dev = torch.device("cuda")
    n_cb, vocab = cfg.num_codebooks, cfg.codebook_size
    out = {}
    for b in FRAME_ROWS:
        hidden = torch.randn((b, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
        window = torch.randint(-1, vocab, (b, n_cb, 12), generator=gen, device=dev,
                               dtype=torch.int32)
        gumbel = gumbel_noise((b, n_cb, 256), gen, dev)
        samp = RowSampling.from_vectors(torch.tensor([[0.7, 0.8, 256.0, 1.4]] * b,
                                                     dtype=torch.float32, device=dev))
        eos = torch.zeros((b,), dtype=torch.bool, device=dev)
        ms = cs.device_ms(torch, lambda: fb.fused_fast_frame_batched(
            p, cfg, samp, hidden, window, gumbel, eos, rope, rep_enabled=True),
            calls=10, replays=5)
        out[f"frame_{kind}_b{b}"] = ms
        print(f"{label}: batched fast frame {kind} B={b} (sampled): {ms:.4f} ms", flush=True)
    return out


def compare(torch, a_path: str, b_path: str) -> int:
    """0 when two --outputs files hold the same bits, shape by shape."""
    a, b = torch.load(a_path), torch.load(b_path)
    same = a.keys() == b.keys()
    for key in sorted(a):
        la, ha, ca = a[key]
        lb, hb, cb = b.get(key, (None, None, None))
        ok = lb is not None and torch.equal(la, lb) and torch.equal(ha, hb) and ca == cb
        same &= ok
        print(f"{key}: logits, hidden and caches {'bit-equal' if ok else 'DIFFER'}")
    print("outputs bit-equal" if same else "outputs DIFFER")
    return 0 if same else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", default="all", choices=("all", "batch1", "rows", "frame"))
    ap.add_argument("--json", default=None, help="write the times here")
    ap.add_argument("--outputs", default=None, help="save the rows part's outputs here")
    ap.add_argument("--compare", nargs=2, default=None, help="hold two --outputs files equal")
    args = ap.parse_args()
    import torch

    if args.compare:
        return compare(torch, *args.compare)

    if not torch.cuda.is_available():
        print("time_decode_stack: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from fish_speech_tpu_torch.config import DualARConfig
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params, rope_tables
    from fish_speech_tpu_torch.ops import quant
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    label = ROOT.name
    print(f"{label}: {smi}", flush=True)
    cfg = DualARConfig.fish_speech_1_5()
    dev = torch.device("cuda")
    params = init_dual_ar_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    params["output"] = params["output"][:, :cfg.codebook_size + 1].contiguous()
    rope = rope_tables(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    samp = SamplingArgs(temp=0.7, top_p=0.8, top_k=256, repetition_penalty=1.4)
    out = {"device": smi}
    outputs = {} if args.outputs else None
    with torch.inference_mode():
        for kind in ("bf16", "int8"):
            p = quant.quantize_lm_params(params) if kind == "int8" else params
            if args.part in ("all", "batch1"):
                out.update(time_batch1(torch, cs, cfg, p, kind, rope, gen, samp, label))
            if args.part in ("all", "rows"):
                out.update(time_rows(torch, cs, cfg, p, kind, rope, gen, label, outputs))
            if args.part in ("all", "frame"):
                out.update(time_frame(torch, cs, cfg, p, kind, rope, gen, label))
    print(json.dumps(out), flush=True)
    if outputs is not None:
        Path(args.outputs).parent.mkdir(parents=True, exist_ok=True)
        torch.save(outputs, args.outputs)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
