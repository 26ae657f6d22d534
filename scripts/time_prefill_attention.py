#!/usr/bin/env python3
"""Device times of flash prefill attention on one NVIDIA GPU.

    python3 scripts/time_prefill_attention.py [--json build/times.json]

Fish-1.5 heads (16 q heads over 2 KV heads, hd 64), bf16, k/v as views
of a 4096-entry cache as on the main path, random inputs from seed 0.
Shapes: S_pad 64 with a 40-token prompt (the main path), S_pad 512,
1024, 2048 and 4096 at offset 0 and full length, and the prefix-reuse
shape (S_pad 128 at offset 1920, 100 tokens, extent 2048). Each time is
the mean of one call over a CUDA graph of back-to-back calls
(`chip_smoke.py`'s `device_ms`, inputs warm in L2), then the eager call.
Then `LMEngine.prefill` of a 2000-token prompt (Fish-1.5 at full width,
random bf16 weights from seed 0, bucket 2048, cache 4096): the median
wall seconds of 5 after a warm-up. It calls only public functions (the
wrapper `ops/prefill_attention.py::prefill_attention` and the engine), so
it times whatever kernel sits behind them: to compare two commits on one
card, unpack the other commit (`git archive`) into a git-ignored
directory, copy this script into its `scripts/`, and run both in one
call, in turns.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (label, S_pad, extent E, offset, prompt length)
SHAPES = (
    ("S64_len40", 64, 64, 0, 40),
    ("S512", 512, 512, 0, 512),
    ("S1024", 1024, 1024, 0, 1024),
    ("S2048", 2048, 2048, 0, 2048),
    ("S4096", 4096, 4096, 0, 4096),
    ("prefix_S128_off1920_len100_E2048", 128, 2048, 1920, 100),
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None, help="write the times here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_prefill_attention: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from fish_speech_tpu_torch.ops import prefill_attention as pa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{ROOT.name}: {smi}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h, kv, hd, cache, window = 16, 2, 64, 4096, 4096
    out = {"device": smi}
    for label, s_pad, e, offset, n in SHAPES:
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
        q, ck, cv = rnd(1, h, s_pad, hd), rnd(1, kv, cache, hd), rnd(1, kv, cache, hd)
        k, v = ck[:, :, :e], cv[:, :, :e]
        sl = torch.tensor([n], dtype=torch.int32, device=dev)
        call = lambda: pa.prefill_attention(q, k, v, offset, sl, window)  # noqa: E731
        ms = cs.device_ms(torch, call, calls=20, replays=5)
        eager = cs.eager_ms(torch, call, 50)
        out[label] = ms
        out[f"{label}_eager"] = eager
        print(f"{ROOT.name}: prefill_attention {label}: {ms:.4f} ms (eager call {eager:.4f} ms)",
              flush=True)
    median, dev_ms, attn_ms = time_engine_prefill(torch)
    out.update(prefill_2000_median_s=median, prefill_2000_device_ms=dev_ms,
               prefill_2000_attention_ms=attn_ms)
    print(f"{ROOT.name}: LMEngine.prefill 2000 tokens: median {median:.4f} s of 5; one "
          f"prefill under torch.profiler: device kernels {dev_ms:.3f} ms, prefill attention "
          f"{attn_ms:.3f} ms ({100 * attn_ms / max(dev_ms, 1e-9):.1f}%)", flush=True)
    print(json.dumps(out), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out))
    return 0


def time_engine_prefill(torch):
    """(median seconds of 5, device ms and attention kernels' ms of one
    profiled prefill)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from fish_speech_tpu_torch.config import DualARConfig, TokenConfig, WhichLM
    from fish_speech_tpu_torch.generate.engine import LMEngine
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    cfg = DualARConfig.fish_speech_1_5()
    tok = TokenConfig(im_end_id=100011, pad_id=5, semantic_start_id=100012,
                      semantic_end_id=100012 + cfg.codebook_size - 1)
    params = init_dual_ar_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    engine = LMEngine(params, cfg, tok, WhichLM.FISH_1_5, max_frames=8)
    n = 2000
    rng = np.random.default_rng(2)
    prompt = np.concatenate([rng.integers(1000, 90000, size=(1, n)),
                             np.zeros((cfg.num_codebooks, n), np.int64)]).astype(np.int32)
    sampling = SamplingArgs(temp=0.7, top_p=0.8, top_k=256, repetition_penalty=1.4)
    state = engine.init_state(0)
    engine.prefill(state, prompt, sampling)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine.prefill(state, prompt, sampling)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.prefill(state, prompt, sampling)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")
               and getattr(e, "self_device_time_total", 0) > 0]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    attn_ms = sum(e.self_device_time_total for e in kernels
                  if "prefill_attention_kernel" in e.key or "prefill_combine_kernel" in e.key) / 1e3
    return float(np.median(times)), dev_ms, attn_ms


if __name__ == "__main__":
    sys.exit(main())
