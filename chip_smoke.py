#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `fish_speech_tpu_torch` (never JAX, never `fish_speech_tpu`) at
the full Fish-1.5 width, on random bf16 weights made from a seed, and
fails (non-zero exit) on the first check that does not hold. One line
per phase, each with the seconds since start:

  1. device   torch version, card name and power limit (nvidia-smi);
     cold     two fresh processes (`chip_smoke.py --cold-start`) to the
              first audio with $FISH_TPU_CACHE_DIR at a new directory:
              import, the kernel library (built by the first, found by
              the second), engine and codec from seeded weights, first
              prefill, first 16-frame decode_chunk, first Firefly
              decode, each timed;
  2. build    the kernels, one nvcc per source started together and one
              link, built by the first cold-start process into that
              directory and loaded from it here (one build a run), the
              build's time, ptxas's register and spill lines, and the
              tensor-core instructions (HGMMA/HMMA) in the prefill
              kernel's SASS by cuobjdump, which must be more than none;
  3. kernels  each CUDA kernel against its plain PyTorch version on the
              card at the main path's shapes (bf16), with the tolerance
              stated, then timed beside the plain version and, where one
              exists, one PyTorch library call used as a yardstick only:
              decode attention (pos 0, 1, 63, 1024, 4095 at cache 4096,
              and 16 rows at cache 512 with ragged pos, one row also
              alone; timed at pos 104 and 4095 and at the serving shape
              beside SDPA), prefill attention (S_pad 64, 100 and 512 at
              offsets 0 and 37, 2048 and 4096 at offset 0, the
              prefix-reuse shape S_pad 128 at offset 1920 over 2048 keys,
              rows of length 1 and 0 beside a full one, a window of 300
              at S_pad 512, each also row by row as close to a float32
              evaluation as the plain version; its contract: five calls
              bit-identical, a CUDA graph's replay, a row alone
              bit-equal to itself among two, two launches counted for a
              key-split call and one otherwise, the plan and every
              CTA's work as built equal to ops/prefill_attention.py's
              mirrors; timed at S_pad 64 with a 40-token prompt, 512,
              1024, 2048 and 4096 and the prefix-reuse shape beside the
              faster of two SDPA calls, with the plan), the fused slow step
              (pos 0, 1, 104, 4095; batch 1 and 2; timed at pos 104,
              255, 256 and 4095), the fused fast frame (32 frames
              sampled, argmax, no rep-pen, EOS), each of these two
              persistent kernels also held to its contract (its plan as
              built equal to ops/decode_stack.py's mirror, one launch a
              call or a persistent and a sampler launch a codebook step,
              grid syncs and key-split exchanges, as the kernels count
              them, equal to the plan's, five calls bit-identical, a
              CUDA graph's replay equal to the eager call, completion
              beside a long kernel on a second stream, and for the
              slow step a row alone bit-equal to itself among four) with
              its grid, shared memory, ring stages and share of the
              bound, and the batched fast frame's persistent kernel (one
              launch a frame: tokens and step logits exact at B = 4 and
              16, argmax, sampled and mixed rows; full-weight step
              logits; its contract as above, with each of 16 rows alone
              bit-equal to itself among 16; timed at B = 4, 16 and 32
              beside the bound and the re-read floor), with each of the
              five GEMMs of the launch sequence it replaced on its own
              (fs_rows_gemm at B = 16 against rows_gemm_plain, a row
              alone bit-equal, timed beside cuBLAS and the byte bound,
              one line a GEMM), and the fused slow step's row kernel
              for 5 rows and more (csrc/slow_step_rows.cu, one
              persistent launch a group of 32 rows: B = 16 at cache 512
              and serving positions 39-167, B = 32 and 64 at cache 256,
              8 at cache 2048 past 1024 keys, each held to the plain
              version's distance to a float32 evaluation, other cache
              rows bit-equal, one launch a group counted by the C entry
              and by the kernel, its grid syncs and head exchanges as
              the kernel counts them equal to the plan's, its plan as
              built equal to ops/decode_stack.py's mirror, each of 16
              rows alone bit-equal to itself among 16, the engine's
              padded head; timed in a CUDA graph beside the plain
              version, the unfused step it replaces and the byte
              bound); then the same four on int8 stacks (the
              kernels' int8 bodies) at the same positions and batches,
              held to the plain version's distance to a float32
              evaluation of the dequantized weights;
  4. main     40-token prompt -> LMEngine.generate at the default
              `auto` decode path (fused slow step + fused fast frame,
              128 frames, temp 0.7 / top_p 0.8 / top_k 256 / rep-pen
              1.4) -> FireflyCodec.decode -> WAV bytes, with the launch
              counts of its kernels; then the unfused path
              (slow_impl = fast_frame_impl = "xla", decode attention,
              32 frames) with its counts, and one full-width unfused
              decode step through the kernels and the plain versions;
              then the int8 engine (quantize_int8=True, quantized on
              the card and checked bit-equal to the CPU quantization)
              on the `auto` path, 128 frames, with its int8 launch
              counts, and the bf16/int8 A/B in turns (bf16, int8, int8,
              bf16);
     prefill  LMEngine.prefill of a 2000-token prompt (bucket 2048,
              cache 4096): median seconds of 5 after a warm-up, and the
              attention kernel's share of device time under
              torch.profiler over one prefill;
     stream   the streaming Firefly-1.5 decode at full width on 128
              frames of seeded codes fed as [128], [5,16,16,...],
              [1]*32+[96] and powers of two, on a copy of the codec
              whose conv_post weight is scaled by a power of two so the
              PCM peaks near 0.3 (the random codec's peaks near 6e-7,
              below int16's step; the later phases use this copy too): a
              float32 copy of the weights streams its batch decode
              within 1e-4 (TF32 off), the bf16 stream is as close to the
              float32 batch decode as the bf16 batch decode is
              (ACCURACY_FACTOR); decode_step timed at 16 and 64 frames,
              batch 1 and 16;
     overlap  generate_vocode_overlapped on the batch-1 `auto` engine
              (40-token prompt, 128 frames, chunk 64): tokens equal
              generate's on the same seed, PCM within the bf16 bound of
              codec.decode and as close to the float32 decode as
              codec.decode is, the prefill, slow-step and fast-frame
              kernels launched; a decode chunk, a feed of host codes and
              a 16-lane central-vocoder tick queue without waiting for
              the card (PyTorch's sync debug mode set to raise); RTF
              best and median of 5 trials after a warm-up, overlapped,
              chunked (the same chunks read one by one, then one batch
              decode) and serial (generate + decode) in turns, and the
              host time of one feed;
     ttfa     bench.py::bench_ttfa's path (cache 512, bucket 64,
              prefill, one 16-frame decode_chunk, one streaming feed):
              p50 and p90 of 11 trials after a warm-up;
     cli      a user's voice-cloning path on checkpoints read from disk:
              the full-width Fish-1.5 bf16 LM (the main path's weights)
              and a float32 Firefly-1.5 codec (seed 1, each FSQ group's
              project_in standardised on the voice, so that its codes
              spread over the grid) written in the upstream key names
              (io/checkpoint.py) and read back onto the card bit-equal;
              a seeded 4 s 24 kHz 16-bit WAV through the encoder CLI
              (read_wav, resample, FireflyCodec.encode) with TF32
              allowed process-wide: codes in [0, 1024), equal to the CPU
              encode of the same weights wherever the CPU's value before
              rounding lies at least 1e-3 from a tie, and on at least
              99.5% in all (the encode turns TF32 off itself); with
              TF32 allowed in the encode, fewer equal; two text chunks behind that speaker
              prompt through llama_generate's generation function (a
              word-level stand-in tokenizer at build_models' ids, 64
              frames a chunk, the CLI's sampling defaults): the speaker's
              codes verbatim in the first prompt, the codes equal to the
              in-memory engine's token for token, the prefill kernel
              launched at the conditioning offset for chunk 2, launch
              counts; the codes through the vocoder CLI to a WAV that
              parses; write and load seconds and each CLI's RTF;
  5. profile  a device_trace (utils/profiling) of 8 decode frames of
              each path (2 of the unfused one) under annotate("decode")
              (its own span left out of the kernels' time): the file parses
              and holds the region, and on the `auto` paths the fused
              kernels' names; device time against the wall;
  6. serving  continuous batching at the serving configuration (16 rows,
              cache 512, horizon 16, rep-pen window 12, dynamic
              sampling): 20 requests of 40 tokens, 128 frames each, all
              submitted at once (four wait for a free row), two argmax
              and two seeded, each client vocoding its own codes; run on
              the slow step's row kernel and the batched fast-frame
              kernel (`auto`), on the unfused slow step and the batched
              kernel (`slow_impl="xla"`: the A/B that decides whether
              `auto` picks the row kernel) and on the unfused codebook
              loop (`fast_frame_impl="xla"`) in turns, with frames/s,
              per-request RTF p50/p95 and a profile of 4 decode frames
              of each; launch counts (the row kernel's one launch a
              decode step, counted by the wrapper and by the kernel, no
              decode attention on `auto`); each seeded
              request is run again alone on a fresh batcher and must give
              the same codes; the int8 serving engine (the int8 bodies of
              the row kernel and the batched frame) takes part in the
              turns, with its own launch counts, profile and seeded
              requests alone; and the central vocoder (the `auto` engine
              under a batcher with codec= the bf16 codec: 20 deliver_pcm
              requests, each one's PCM events before its result and
              within the bf16 bound + 5e-5 of codec.decode of its
              tokens, as close to the float32 decode as codec.decode is,
              its reference peaking at 100 int16 steps or more;
              frames/s, RTF p50/p95 to the last PCM, TTFA
              p50/p95 to the first) takes two turns (auto, central,
              slow_xla, xla, int8, int8, xla, slow_xla, central, auto),
              and a profile of 4 central-vocoding ticks gives the
              vocoder's share of device time;
     server   the serving surface as a user runs it: a TTSPipeline built
              by its constructor on the batch-1 weights (cache 512), the
              loud bf16 codec and the stand-in tokenizer, reroll off, with
              create_batcher(16, 16), behind the port's aiohttp app on
              localhost (the aiohttp-free core where aiohttp is missing):
              20 requests at once (10 streaming Ogg/Opus with
              stream_chunk_frames 16, 10 WAV; two seeded, two at temp 0;
              where the native library does not build, Opus answers 501
              and the streaming clients read the core's PCM stream), each
              checked against the codes the batcher produced; the seeded
              and temp-0 requests against synthesize_streaming_continuous
              called directly (codes equal, PCM within twice the bf16
              bound); a client that leaves after its first audio (its
              row free within two ticks); a voice through
              /v1/audio/encoding and a request in it; a batch_size 2
              request (decode attention), a serial and a hidden-states
              request (the batch-1 fused kernels) on a second app; the
              kernels each route launched; requests/s, frames/s, client
              RTF and TTFA p50/p95, the Opus host ms a chunk, the
              cancel-to-free seconds and whether libfishaudio.so built;
     versions every other model family at full width on random bf16
              weights, one at a time (each freed before the next): Fish
              1.2 (its published config, the non-causal Firefly-1.2
              codec), Fish 1.4 (stand-in widths: the 1.2 backbone with 8
              codebooks of 1024; the streaming Firefly-1.4 codec) and
              DualAR (stand-in widths: the 1.5 backbone, depthwise
              embeddings and heads, 8 codebooks of 2048, a vocab holding
              the stand-in tokenizer's 2048 semantic ids; Mimi at
              kyutai/mimi's widths, float32, its random weights written
              in transformers' names and read back through the port's
              loader); the stand-ins because no Fish 1.4 or smoltts
              config.json is in the repo. For each: the persistent slow
              step (batch 1, the 2-column [PAD, <|im_end|>] head of Fish
              <= 1.4 or DualAR's 2049 columns), the row kernel (16 rows),
              the batch-1 fast frame (V = 2048 takes the sampler's two
              items a thread) and the batched frame (16 rows; C = 4 for
              Fish 1.2; depthwise for DualAR), on the engines and
              weights that version's path runs, through the kernels
              phase's checks (plans, contracts, bounds and times at
              these shapes; where the weights carry the PAD bias in
              hidden dimension 0, the hidden held over the others and a
              2-column head's logits pooled over every row of every
              case; for DualAR also on int8 stacks, the kernels' int8
              bodies at V = 2048); batch 1 on `auto` (40
              tokens, 64 frames, the legacy PAD/EOS draw for Fish <= 1.4,
              DualAR's codebook rep-pen off) vocoded to a WAV, 8 frames on the
              unfused path (decode attention); 8 requests through
              TTSPipeline.create_batcher(16, 16) (the central vocoder
              for 1.4 and DualAR, clients decoding for 1.2), two seeded,
              each equal alone; frames/s and RTF p50; for DualAR, Mimi's
              card decode within 1e-4 of the CPU's, its stream in uneven
              pieces within 1e-4 of its batch decode, decode_step timed,
              and generate_vocode_overlapped with Mimi (chunk 64);
  7. int8     the int8 proxy of bench.py --int8-proxy at full size on the
              same weights: teacher-forced and free-running agreement of
              the int8 and bf16 engines, mel-L1 and SNR of the two
              predictions' PCM against the bf16-vs-float32 vocoder
              floor, and utils/int8_policy.evaluate's verdict (reported;
              random weights are not what the criteria are for; no
              decision file is written);
  8. parallel parallel serving (`fish_speech_tpu_torch/parallel/`) at
              Fish 1.5's width on the seed-0 weights, worlds of spawned
              ranks through `parallel.dryrun.serving_dryrun`: (a) one
              rank on nccl (dp = tp = 1): the sharded engine's prefill
              and 32 frames on the unfused path bit-equal to the
              unsharded engine's (tokens and logits); (b) two ranks on
              this one card over gloo at tp = 2: decode attention at a
              rank's shape (8 q heads over 1 KV head: B = 1 at pos 0, 1,
              104 and 4095 at cache 4096, 16 rows at cache 512 with
              ragged pos) against its plain version with the kernels
              phase's tolerance and timed beside SDPA and its byte
              bound; 32 sampled frames of the sharded batch-1 engine,
              whose logits must be as close to a float32 evaluation on
              their own context as the unsharded engine's are on theirs
              (ACCURACY_FACTOR), with the token agreement of the two;
              4 requests through the sharded pipeline's
              create_batcher(16, 16) and its central vocoder, PCM for
              every one, frames/s (two ranks sharing one card over gloo:
              not a speed of tensor parallelism); (c) two ranks at dp =
              2 through the batcher, laid out as two hosts of one rank
              each (dp across the hosts, each rank local id 0 of its
              host and on cuda:0; (b) stays one host of two ranks), 16
              requests on the unfused path: each request's codes
              against the unsharded batcher's (the first frame's
              semantic token equal, the agreement printed). Every rank
              launched both attention kernels; no rank holds a JAX
              module; (c) logs every rank's host, local id and card;
  9. train    finetuning at Fish 1.5's published widths in float32 with
              TF32 off: 3 steps at 2 slow layers (the fast stack whole,
              B = 2, S = 128) on the card and on this machine's CPU from
              the same weights (loss and grad_norm within 1e-4
              relative, moments within 1e-4 of each leaf's largest,
              parameters within one step's lr); 12 full-depth steps of
              the finetune CLI's function on 16 seeded pairs of 200-400
              frames (seq-len 512, B = 4, lr 1e-4, warmup 2), remat on
              and off: the loss falls, s/step (median of the last 8),
              real tokens/s and peak memory (utils/profiling); at 2 slow
              layers, 4 steps straight against 2, a snapshot and
              --resume to 4, bitwise equal; the trained checkpoint in
              bf16 through load_lm_params into the `auto` engine, 16
              frames through the fused kernels, with their launches.
  graph (after cli) the decode loop as CUDA graphs
              (generate/graph.py), each path against an eager twin of
              its engine (`sibling(decode_impl="eager")`): batch-1
              `auto` bf16 and int8 at 128 frames and `xla` at 32, codes
              identical on one seed and after a rewind to the prompt;
              16 seeded requests through a bf16 and an int8
              TTSPipeline(...).create_batcher(16, 16) and their eager
              twins, each request's codes identical; the overlapped
              driver replaying the same loops; one capture per key over
              more requests; the replays' frames against the persistent
              kernels' own device counters (rows 3-5a) and decode
              attention's launches under torch.profiler (row 1);
              frames/s and a frame's wall against device ms in each
              mode, capture seconds and a generate call's host reads.

The kernel launch counts are read around the run of the path that
launches the kernel: the bf16 kernels in the bf16 runs, the int8 bodies
(each wrapper's int8_launches) in the int8 runs; each bf16 kernel's
entry also carries its launches on each version's paths
(`version_launches`), and each kernel its errors, times and bounds at
each version's shapes where that version runs it (`versions`); decode
and prefill attention also carry each rank's launches in each world of
the parallel phase (`parallel_launches`), and decode attention its
checks and times at a tp = 2 rank's shape (`tp2_rank_shape`, row 1p).
Those bulkier extras (`versions`, `gemms`, `timings`, `rel_vs_float32`,
`tp2_rank_shape`, `long_prefill`) are printed on a `{"kernel_details":
...}` line of their own, then one `phase <name>: <s>s, held` line a
phase, so that the last 24,000 bytes keep the summary.

The line before the last is the card's nvidia-smi name and power
limit, the one before it a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without CUDA, or without
the package beside the script, it prints no result and exits 2.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import io
import itertools
import json
import re
import shutil
import subprocess
import sys
import time
import wave

T0 = time.perf_counter()

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): the
# bound of a kernel is the larger of its bytes over the memory rate and
# its operations over the bf16 tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# Tolerances, kernel against plain version, both in bf16 on the card.
# Decode: the weights are rounded to bf16 at the same point in both, but
# the sums run in another order, so an output may land one bf16 ulp
# (2^-8 relative) away; the cache write is a copy and must be exact.
DECODE_ATOL = DECODE_RTOL = 1e-2
# Prefill: the kernel rounds the unnormalised online-softmax weights to
# bf16 (as the TPU kernel does), the plain version the normalised ones.
PREFILL_ATOL = PREFILL_RTOL = 2e-2
# That absolute bound is loose where a query sees thousands of keys: its
# outputs are then a few hundredths. So each (head, query) row's relative
# distance ||out - ref|| / ||ref|| to a float32 evaluation of the same
# function (the plain version on float32 copies of q, k and v) is also
# held, at its largest, within ACCURACY_FACTOR (below) of the plain
# version's own.
# One full decode step, kernels vs plain versions: attention outputs one
# bf16 ulp apart feed 24 bf16 layers; logits are ~N(0, 0.6).
STEP_LOGITS_ATOL = 5e-2
# Fused slow step and fast frame against their plain versions. Both sum
# every product in another order than cuBLAS, and a bf16 result one ulp
# away moves every later RMSNorm, so after a few layers most values of
# the two differ, as two bf16 runs of the same model do; measured at
# full width, the plain version's own distance to a float32 evaluation
# of the same function (the plain version on the float32 copy of the
# weights) is as large as its distance to the kernel. So each output
# (logits, hidden, new cache rows, each fast step's logits) is held to
# be as close to the float32 evaluation as the plain version is, within
# ACCURACY_FACTOR on the largest error; cache rows other than pos must be
# bit-equal.
ACCURACY_FACTOR = 2.0
# The fast frame's tokens follow the sampler's rank order, which any
# such difference reshuffles, so they are held exactly equal on inputs
# that make every sum exact: zero fast-layer weights, one-hot hidden and
# one-hot embedding rows (each step's logits are then 32 x one head row,
# exact in both versions, and bf16-valued, so ties are common).
FAST_FRAMES = 32
N_FRAMES = 128
N_FRAMES_UNFUSED = 32
PROMPT_LEN = 40
SAMPLING = dict(temp=0.7, top_p=0.8, top_k=256, repetition_penalty=1.4)

# The serving configuration (bench.py::_serving_setup, pipeline.py::
# create_batcher): 16 decode rows, cache 512, horizon 16, prompt bucket 64.
SERVE_ROWS = 16
SERVE_CACHE = 512
SERVE_HORIZON = 16
SERVE_REQUESTS = 20
SERVE_ARGMAX = (5, 12)  # requests at temp 0
SERVE_SEEDED = (3, 17)  # requests with a seed
WAIT_S = 300.0  # longest wait for one batcher event


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {phase}: {msg}", flush=True)


PHASES = []  # (name, seconds) of each phase that ran to its end, every check held
# per-kernel extras printed apart from the kernels line (`main`)
DETAIL_KEYS = ("versions", "gemms", "timings", "rel_vs_float32", "tp2_rank_shape",
               "long_prefill")


@contextlib.contextmanager
def phase(name: str):
    """Time a phase for the summary printed before the kernels line."""
    t0 = time.perf_counter()
    yield
    PHASES.append((name, time.perf_counter() - t0))


class CheckFailed(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def eager_ms(torch, fn, iters: int) -> float:
    """Mean time of one call launched from Python, back to back, by CUDA
    events: the device time, or the host's launch time where that is
    longer."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, calls: int = 50, replays: int = 10) -> float:
    """Mean device time of one call: `calls` calls captured in one CUDA
    graph, replayed `replays` times and timed by CUDA events, so the
    host's launch cost is out of the number. Inputs stay warm in L2."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):  # the warm-up's stream, whose sync state exists
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def within(torch, got, ref, atol: float, rtol: float):
    """(max abs error, all within atol + rtol * |ref|)."""
    diff = (got.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return float(diff.max()), ok


# --------------------------------------------------------------------------
# Phase 3: kernels
# --------------------------------------------------------------------------


def check_decode_kernel(torch, cfg, cache_len: int, main_pos: int):
    from fish_speech_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    h, kv, hd, n_layer = cfg.n_head, cfg.n_local_heads, cfg.head_dim, cfg.n_layer
    layer = 5

    def inputs(pos):
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
        return (rnd(1, h, hd), rnd(1, kv, hd), rnd(1, kv, hd),
                torch.tensor([pos], dtype=torch.int32, device=dev),
                rnd(n_layer, 1, kv, cache_len, hd), rnd(n_layer, 1, kv, cache_len, hd))

    max_err = 0.0
    for pos in (0, 1, 63, 1024, cache_len - 1):
        q, kn, vn, p, ck, cv = inputs(pos)
        ck2, cv2 = ck.clone(), cv.clone()
        got = da.decode_attention(q, kn, vn, p, ck, cv, layer)
        ref = da.decode_attention_plain(q, kn, vn, p, ck2, cv2, layer)
        torch.cuda.synchronize()
        check(torch.equal(ck, ck2) and torch.equal(cv, cv2),
              f"decode_attention pos={pos}: cache differs from the plain version")
        err, ok = within(torch, got, ref, DECODE_ATOL, DECODE_RTOL)
        check(ok, f"decode_attention pos={pos}: max abs err {err}")
        max_err = max(max_err, err)
        log("kernels", f"decode_attention pos={pos} layer={layer}: cache bit-equal, "
            f"attn max_abs_err={err:.3e} (atol={DECODE_ATOL}, rtol={DECODE_RTOL})")

    # the serving shape: 16 rows, cache 512, a ragged pos per row
    g_rows = torch.Generator(device=dev).manual_seed(4321)
    pos_rows = torch.randint(39, 168, (SERVE_ROWS,), generator=g_rows, device=dev,
                             dtype=torch.int32)
    serve_in = serving_decode_inputs(torch, cfg, gen, pos_rows)
    q, kn, vn, p, ck, cv = serve_in
    ck2, cv2 = ck.clone(), cv.clone()
    got = da.decode_attention(q, kn, vn, p, ck, cv, layer)
    ref = da.decode_attention_plain(q, kn, vn, p, ck2, cv2, layer)
    alone = da.decode_attention(q[3:4].clone(), kn[3:4].clone(), vn[3:4].clone(), p[3:4].clone(),
                                ck2[:, 3:4].clone(), cv2[:, 3:4].clone(), layer)
    torch.cuda.synchronize()
    check(torch.equal(ck, ck2) and torch.equal(cv, cv2),
          "decode_attention serving shape: cache differs from the plain version")
    err, ok = within(torch, got, ref, DECODE_ATOL, DECODE_RTOL)
    check(ok, f"decode_attention serving shape: max abs err {err}")
    check(torch.equal(alone, got[3:4]), "decode_attention: row 3 alone differs from row 3 of 16")
    max_err = max(max_err, err)
    log("kernels", f"decode_attention B={SERVE_ROWS} cache={SERVE_CACHE} pos "
        f"{int(p.min())}..{int(p.max())} layer={layer}: cache bit-equal, attn max_abs_err="
        f"{err:.3e} (atol={DECODE_ATOL}, rtol={DECODE_RTOL}); row 3 alone bit-equal to row 3 "
        f"among {SERVE_ROWS}")

    # timings: batch 1 at the main path's pos and at the cache's end, and
    # the serving shape; SDPA on the same valid K/V is the yardstick
    timed = {}
    for label, args in ((f"B=1 pos={main_pos}", inputs(main_pos)),
                        (f"B=1 pos={cache_len - 1}", inputs(cache_len - 1)),
                        (f"B={SERVE_ROWS} cache={SERVE_CACHE} ragged", serve_in)):
        timed[label] = time_decode(torch, da, cfg, args, layer)
        t = timed[label]
        log("kernels", f"decode_attention {label}: kernel {t['ms']:.4f} ms (eager call "
            f"{t['eager_call_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, sdpa "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']}); "
            f"{t['blocks']} blocks in clusters of {t['cluster']}")
    main = timed[f"B=1 pos={main_pos}"]
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "fish_speech_tpu_torch/csrc/decode_attention.cu",
        "replaces": "fish_speech_tpu/ops/attention_pallas.py:125",
        "max_abs_err": max_err, **{k: v for k, v in main.items() if k not in ("cluster", "blocks")},
        "kernel_ms": main["ms"],
        "shape": f"q (1,{h},{hd}), cache ({n_layer},1,{kv},{cache_len},{hd}) bf16, pos {main_pos}",
        "timings": timed,
    }


def serving_decode_inputs(torch, cfg, gen, pos):
    """Decode attention inputs at the serving shape: one row per pos,
    caches of SERVE_CACHE."""
    dev = pos.device
    b, h, kv, hd, n_layer = len(pos), cfg.n_head, cfg.n_local_heads, cfg.head_dim, cfg.n_layer
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
    return (rnd(b, h, hd), rnd(b, kv, hd), rnd(b, kv, hd), pos,
            rnd(n_layer, b, kv, SERVE_CACHE, hd), rnd(n_layer, b, kv, SERVE_CACHE, hd))


def time_decode(torch, da, cfg, args, layer: int) -> dict:
    """Kernel, eager call, plain version and SDPA (over each row's valid
    keys, by a mask) on one input set; the bound of this input's work."""
    q, kn, vn, p, ck, cv = args
    kernel = lambda: da.decode_attention(q, kn, vn, p, ck, cv, layer)  # noqa: E731
    ms = device_ms(torch, kernel)
    call_ms = eager_ms(torch, kernel, 200)
    plain_ms = device_ms(torch, lambda: da.decode_attention_plain(q, kn, vn, p, ck, cv, layer))
    b, h, hd = q.shape
    kv, s = ck.shape[2], ck.shape[3]
    n_max = int(p.max()) + 1
    kc, vc = ck[layer, :, :, :n_max], cv[layer, :, :, :n_max]
    valid = (torch.arange(n_max, device=q.device)[None, :] <= p[:, None].long())[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = None if b == 1 else valid  # one row: every key up to pos is valid
    library_ms = device_ms(torch, lambda: sdpa(q[:, :, None], kc, vc, attn_mask=mask,
                                               enable_gqa=True))
    # bytes: q, k_new, v_new, pos and each row's K/V rows 0..pos read
    # once; attn and the new cache rows written once. flops: QK^T and PV.
    keys = int((p.long() + 1).sum())
    nbytes = (b * (2 * (h * hd + 2 * kv * hd) + 4) + 2 * (2 * kv * keys * hd)
              + b * 2 * (h * hd + 2 * kv * hd))
    bound_ms, bound_by = bound(nbytes, 4 * h * keys * hd)
    plan = da.decode_plan(s)
    return {"ms": ms, "eager_call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "cluster": plan.cluster,
            "blocks": plan.blocks(b, kv)}


# Prefill attention, timed at the main path's 40-token prompt, at full
# prompts of 512-4096 tokens (a voice-cloning prompt carries 215-645
# frames of reference audio before its text) and at the prefix-reuse
# shape (a later text chunk at offset 1920 after a kept conditioning
# prefix): (label, S_pad, extent E, offset, length).
PREFILL_TIMED = (
    ("S_pad=64 len=40", 64, 64, 0, PROMPT_LEN),
    ("S_pad=512", 512, 512, 0, 512),
    ("S_pad=1024", 1024, 1024, 0, 1024),
    ("S_pad=2048", 2048, 2048, 0, 2048),
    ("S_pad=4096", 4096, 4096, 0, 4096),
    ("prefix S_pad=128 offset=1920 len=100 E=2048", 128, 2048, 1920, 100),
)


def visible_pairs(offset: int, n: int, e: int, window: int) -> int:
    """(query, key) pairs the prefill rule lets the n valid queries see."""
    lim = min(e, offset + n)
    return sum(max(0, min(offset + i, lim - 1) - max(0, offset + i - window + 1) + 1)
               for i in range(n))


def check_prefill_kernel(torch, cfg, cache_len: int, sass_tensor_ops: int):
    from fish_speech_tpu_torch.ops import prefill_attention as pa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    h, kv, hd, window = cfg.n_head, cfg.n_local_heads, cfg.head_dim, cfg.max_seq_len
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def inputs(b, s_pad, e, lens):
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
        # k/v are views of a cache-shaped buffer, as on the main path
        ck, cv = rnd(b, kv, cache_len, hd), rnd(b, kv, cache_len, hd)
        return (rnd(b, h, s_pad, hd), ck[:, :, :e], cv[:, :, :e],
                torch.tensor(lens, dtype=torch.int32, device=dev))

    max_err, rel_errs = 0.0, {}

    def row_rel_err(got, ref32):
        """Largest ||got - ref|| / ||ref|| over the (head, query) rows."""
        return float(((got.float() - ref32).norm(dim=-1) / ref32.norm(dim=-1)).max())

    def against_plain(s_pad, e, offset, lens, win=window):
        nonlocal max_err
        q, k, v, sl = args = inputs(len(lens), s_pad, e, lens)
        got = pa.prefill_attention(q, k, v, offset, sl, win)
        ref = pa.prefill_attention_plain(q, k, v, offset, sl, win)
        ref32 = pa.prefill_attention_plain(q.float(), k.float(), v.float(), offset, sl, win)
        torch.cuda.synchronize()
        what = f"prefill_attention S_pad={s_pad} E={e} offset={offset} seq_lens={lens} window={win}"
        check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite output")
        err, rel_k, rel_p = 0.0, 0.0, 0.0
        for b, n in enumerate(lens):
            if n == 0:
                continue
            e_b, ok = within(torch, got[b, :, :n], ref[b, :, :n], PREFILL_ATOL, PREFILL_RTOL)
            check(ok, f"{what} row {b}: max abs err {e_b}")
            err = max(err, e_b)
            rk, rp = row_rel_err(got[b, :, :n], ref32[b, :, :n]), row_rel_err(ref[b, :, :n],
                                                                              ref32[b, :, :n])
            check(rk <= ACCURACY_FACTOR * rp + 1e-6, f"{what} row {b}: relative distance to the "
                  f"float32 evaluation {rk:.3e}, plain version {rp:.3e}")
            rel_k, rel_p = max(rel_k, rk), max(rel_p, rp)
        max_err = max(max_err, err)
        rel_errs[what] = (rel_k, rel_p)
        log("kernels", f"{what}: all finite, valid rows max_abs_err={err:.3e} "
            f"(atol={PREFILL_ATOL}, rtol={PREFILL_RTOL}); largest row relative distance to "
            f"float32 {rel_k:.3e}, plain version {rel_p:.3e} (factor {ACCURACY_FACTOR})")
        return got, args

    for s_pad in (64, 100, 512):
        for offset in (0, 37):
            against_plain(s_pad, offset + s_pad, offset, [s_pad, max(1, (2 * s_pad) // 3)])
    against_plain(2048, 2048, 0, [2048, 2000])
    against_plain(4096, 4096, 0, [4096])
    against_plain(128, 2048, 1920, [100])
    against_plain(128, 2048, 1920, [128, 1, 0])  # rows of length 1 and 0 beside a full one
    against_plain(64, 64, 0, [64, 1, 0])
    against_plain(512, 512, 0, [512, 341], win=300)  # the window edge inside the extent

    # the contract, at the prefix-reuse shape (split keys and a combine)
    got, (q, k, v, sl) = against_plain(128, 2048, 1920, [100, 77])
    call = lambda: pa.prefill_attention(q, k, v, 1920, sl, window)  # noqa: E731
    check(all(torch.equal(call(), got) for _ in range(5)),
          "prefill_attention: five calls are not bit-identical")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(captured, got), "prefill_attention: CUDA graph replay differs from eager")
    alone = pa.prefill_attention(q[1:].clone(), k[1:].clone(), v[1:].clone(), 1920,
                                 sl[1:].clone(), window)
    check(torch.equal(alone, got[1:]), "prefill_attention: row 1 alone differs from row 1 of 2")
    # the count: the blocks and the combine where keys are split, else one
    counted = {}
    for s_pad, e, offset, lens in ((128, 2048, 1920, [100, 77]), (2048, 2048, 0, [2048])):
        q, k, v, sl = inputs(len(lens), s_pad, e, lens)
        pa.launches = 0
        pa.prefill_attention(q, k, v, offset, sl, window)
        want = 2 if pa.prefill_plan(s_pad, e, h, kv, sms).splits > 1 else 1
        check(pa.launches == want, f"prefill_attention S_pad={s_pad} E={e}: counted "
              f"{pa.launches} launches, the call makes {want}")
        counted[f"S_pad={s_pad} E={e}"] = pa.launches
    check(counted["S_pad=128 E=2048"] == 2, f"prefix-reuse shape counted {counted}, expected 2")
    for _, s_pad, e, offset, n in PREFILL_TIMED:
        card, mirror = pa.plan_on_card(s_pad, e, h, kv, sms), pa.prefill_plan(s_pad, e, h, kv, sms)
        check(card == mirror, f"prefill plan S_pad={s_pad} E={e}: card {card}, mirror {mirror}")
        for lens, win in (([n, max(1, n // 3), 0], window), ([n, 1], 300)):
            card = pa.cta_work_on_card(s_pad, e, h, kv, sms, offset, lens, win)
            check(card == pa.cta_work(mirror, len(lens), kv, s_pad, e, offset, lens, win),
                  f"prefill CTA work S_pad={s_pad} E={e} offset={offset} seq_lens={lens} "
                  f"window={win}: the kernel's differs from ops/prefill_attention.py::cta_work")
    log("kernels", f"prefill_attention contract: 5 calls bit-identical, CUDA graph replay equal "
        f"to eager, row 1 alone bit-equal to row 1 of 2 (S_pad=128 offset=1920 E=2048, key "
        f"split and combine); launches counted a call {json.dumps(counted)}; plan and every "
        f"CTA's work as built equal to ops/prefill_attention.py::prefill_plan and cta_work at "
        f"the {len(PREFILL_TIMED)} timed shapes; {sass_tensor_ops} tensor-core instructions "
        f"in the kernel's SASS")

    timed = {}
    for label, s_pad, e, offset, n in PREFILL_TIMED:
        timed[label] = t = time_prefill(torch, pa, h, kv, sms, inputs(1, s_pad, e, [n]), offset,
                                        window)
        log("kernels", f"prefill_attention {label}: kernel {t['ms']:.4f} ms (eager call "
            f"{t['eager_call_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms ({t['library']}), bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}), {100 * t['share_of_bound']:.1f}% of it; plan: {t['plan']}")
    main = timed[PREFILL_TIMED[0][0]]
    return {
        "name": "prefill_attention", "route": "cuda",
        "source": "fish_speech_tpu_torch/csrc/prefill_attention.cu",
        "replaces": "fish_speech_tpu/ops/prefill_pallas.py:214",
        "max_abs_err": max_err, "rel_vs_float32": rel_errs,
        **{k: v for k, v in main.items() if k != "plan"},
        "kernel_ms": main["ms"], "plan": main["plan"], "sass_tensor_ops": sass_tensor_ops,
        "shape": f"q (1,{h},64,{hd}), k/v (1,{kv},64,{hd}) bf16, len {PROMPT_LEN}",
        "timings": timed,
    }


def time_prefill(torch, pa, h, kv, sms, args, offset: int, window: int) -> dict:
    """Kernel (CUDA graph and eager), plain version and the faster of two
    SDPA calls on one input set (B = 1), with the bound of this input's
    work: bytes of q, k, v (the extent), seq_lens and the output once;
    operations 4 * H * (visible pairs of the valid queries) * hd."""
    q, k, v, sl = args
    _, _, s_pad, hd = q.shape
    e, n = k.shape[2], int(sl[0])
    big = s_pad * e >= 1024 * 1024  # the plain version's score tensor is large
    kernel = lambda: pa.prefill_attention(q, k, v, offset, sl, window)  # noqa: E731
    ms = device_ms(torch, kernel)
    call_ms = eager_ms(torch, kernel, 50)
    plain_ms = device_ms(torch, lambda: pa.prefill_attention_plain(q, k, v, offset, sl, window),
                         calls=5 if big else 50, replays=2 if big else 10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    allowed = pa.prefill_mask(s_pad, e, offset, sl, window) == 0
    libs = {"SDPA, boolean mask, enable_gqa": device_ms(
        torch, lambda: sdpa(q, k, v, attn_mask=allowed, enable_gqa=True),
        calls=10 if big else 50, replays=5 if big else 10)}
    if offset == 0 and n == s_pad == e and window >= e:
        libs["SDPA is_causal, enable_gqa"] = device_ms(
            torch, lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
    library = min(libs, key=libs.get)
    nbytes = 2 * (h * s_pad * hd) * 2 + 2 * (2 * kv * e * hd) + 4
    bound_ms, bound_by = bound(nbytes, 4 * h * visible_pairs(offset, n, e, window) * hd)
    plan = pa.prefill_plan(s_pad, e, h, kv, sms)
    return {"ms": ms, "eager_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": libs[library], "library": library, "bound_ms": bound_ms,
            "bound_by": bound_by, "share_of_bound": bound_ms / ms,
            "plan": (f"{plan.ctas} CTAs of {plan.rows} rows ({plan.queries} queries x "
                     f"{h // kv} q heads), key split {plan.splits} (chunks of {plan.chunk} "
                     f"tiles of {plan.block_n} keys), {plan.stages} ring stages")}


def sass_tensor_ops(nvcc: str, lib_path) -> int:
    """Tensor-core instructions (HGMMA, HMMA) in the prefill kernel's SASS
    of the built library, by cuobjdump."""
    from pathlib import Path

    tool = Path(nvcc).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    count, inside = 0, False
    for line in out.splitlines():
        if "Function :" in line:
            inside = "prefill_attention_kernel" in line
        elif inside and re.search(r"\bH(G)?MMA\b", line):
            count += 1
    return count


def bound(nbytes: int, flops: int):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within_ulp(torch, got, ref):
    """(largest distance in bf16 ulps, all within one ulp). The ulp is
    that of the larger magnitude of the two values."""
    mag = torch.maximum(got.float().abs(), ref.float().abs())
    _, exp = torch.frexp(mag)
    ulp = torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), exp - 8),
                      torch.full_like(mag, 2.0 ** -133))
    n_ulp = (got.float() - ref.float()).abs() / ulp
    return float(n_ulp.max()), bool((n_ulp <= 1).all())


def layer_elems(cfg) -> int:
    """Weight elements of one DualAR layer (the norms included)."""
    d, f = cfg.dim, cfg.intermediate_size
    qkv = (cfg.n_head + 2 * cfg.n_local_heads) * cfg.head_dim
    return d * qkv + d * d + 3 * d * f + 2 * d


def layer_bytes(cfg, int8: bool) -> int:
    """Bytes of one DualAR layer's weights: bf16, or int8 matmul weights
    with one bf16 scale per output column (the norms stay bf16)."""
    if not int8:
        return 2 * layer_elems(cfg)
    d, f = cfg.dim, cfg.intermediate_size
    qkv = (cfg.n_head + 2 * cfg.n_local_heads) * cfg.head_dim
    return (layer_elems(cfg) - 2 * d) + 2 * (qkv + d + 2 * f + d) + 2 * 2 * d


def fast_weight_bytes(cfg, int8: bool):
    """(bytes of the fast stack's weights, bytes one codebook step reads
    of them): the layers (int8 ones with their scales), the final norm
    and the head, which under depthwise_output is a d x V slice a step."""
    d, v = cfg.dim, cfg.codebook_size
    step = cfg.n_fast_layer * layer_bytes(cfg, int8) + 2 * (d + d * v)
    heads = cfg.num_codebooks if cfg.depthwise_output else 1
    return step + (heads - 1) * 2 * d * v, step


def is_int8(engine) -> bool:
    from fish_speech_tpu_torch.ops.quant import is_quantized

    return is_quantized(engine.params["slow"]["wqkv"])


def float32_copy(tree):
    """The parameter tree with every tensor in float32 and int8 weights
    dequantized (the reference)."""
    from fish_speech_tpu_torch.ops.quant import dequantize_weight, is_quantized

    if is_quantized(tree):
        return dequantize_weight(tree)
    if isinstance(tree, dict):
        return {k: float32_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(float32_copy(v) for v in tree)
    return tree.float()


def first_layers(stack, n: int):
    """The first n layers of a stacked (dense or int8) parameter dict."""
    from fish_speech_tpu_torch.ops.quant import is_quantized

    return {k: ({"q": v["q"][:n], "s": v["s"][:n]} if is_quantized(v) else v[:n])
            for k, v in stack.items()}


def as_accurate(name: str, got, plain, ref):
    """(kernel's, plain's) largest distance to the float32 evaluation;
    fails unless the kernel's is within ACCURACY_FACTOR of the plain's."""
    err_k = float((got.float() - ref.float()).abs().max())
    err_p = float((plain.float() - ref.float()).abs().max())
    check(err_k <= ACCURACY_FACTOR * err_p + 1e-6,
          f"{name}: {err_k:.4e} from the float32 evaluation, plain version {err_p:.4e}")
    return err_k, err_p


# Fish <= 1.4's head gathers [PAD, <|im_end|>]: too few logits a row for
# their largest distance to a float32 evaluation to say anything case by
# case, so a head of fewer columns is held over every row of every case
SMALL_HEAD = 64
# version_params' embedding dimension 0 for Fish <= 1.4: PAD's head column
# reads it alone, so PAD wins the random PAD/EOS draw on random weights
PAD_BIAS = 30.0


def held_dims(params) -> int:
    """The first hidden dimension held to the plain version's largest
    distance: 1 where the weights carry PAD_BIAS in dimension 0 (a value
    of ~30 among ~1, whose own bf16 roundings set the largest distance of
    every case; it reaches the PAD logit, held pooled), else 0."""
    return int(bool((params["embeddings"][:, 0] == PAD_BIAS).all()))


def step_errors(torch, what: str, outs, caches, rows, p, h0: int, pool: list) -> dict:
    """One slow step against the plain version's distance to a float32
    evaluation (`as_accurate`). outs: (logits, hidden) of the kernel, the
    plain version and the float32 evaluation; caches: their (k, v). The
    hidden over dimensions h0 on (`held_dims`; dimension 0's distances are
    reported), each row's new K/V rows, the logits, or for a head of fewer
    than SMALL_HEAD columns their triple appended to `pool`
    (`pooled_logits`); the other cache rows bit-equal. Returns {part:
    (kernel, plain)}."""
    (got_l, got_h), (pl_l, pl_h), (ref_l, ref_h) = outs
    (ck, cv), (ckp, cvp), (ck32, cv32) = caches
    errs = {}
    if got_l.shape[-1] >= SMALL_HEAD:
        errs["logits"] = as_accurate(f"{what} logits", got_l, pl_l, ref_l)
    else:
        pool.append((got_l, pl_l, ref_l))
    errs["hidden"] = as_accurate(f"{what} hidden" + (" dims 1.." if h0 else ""),
                                 got_h[:, h0:], pl_h[:, h0:], ref_h[:, h0:])
    if h0:
        errs["hidden dim 0 (reported)"] = tuple(
            float((t[:, 0].float() - ref_h[:, 0]).abs().max()) for t in (got_h, pl_h))
    errs["new k rows"] = as_accurate(f"{what} new k rows", ck[:, rows, :, p], ckp[:, rows, :, p],
                                     ck32[:, rows, :, p])
    errs["new v rows"] = as_accurate(f"{what} new v rows", cv[:, rows, :, p], cvp[:, rows, :, p],
                                     cv32[:, rows, :, p])
    for kv_name, got_c, pl_c in (("k", ck, ckp), ("v", cv, cvp)):
        rest = got_c.clone()
        rest[:, rows, :, p] = pl_c[:, rows, :, p]
        check(torch.equal(rest, pl_c), f"{what}: {kv_name} cache rows other than pos changed")
    return errs


def pooled_logits(torch, what: str, pool: list, phase: str):
    """A small head's logits (`step_errors`) over every row of every case
    at once against the plain version's distance to the float32
    evaluation. Returns (kernel, plain), or None for an empty pool."""
    if not pool:
        return None
    got, plain, ref = (torch.cat([c[i].float() for c in pool]) for i in range(3))
    errs = as_accurate(f"{what} logits pooled over {got.shape[0]} rows", got, plain, ref)
    log(phase, f"{what}: logits of the {got.shape[1]}-column head pooled over {got.shape[0]} "
        f"rows, max abs distance to the float32 evaluation, kernel {errs[0]:.4e} | plain "
        f"{errs[1]:.4e}")
    return errs


def check_slow_step(torch, engine, params32, main_pos: int, label: str = ""):
    from fish_speech_tpu_torch.ops import decode_stack as ds
    from fish_speech_tpu_torch.ops import slow_step as ss

    cfg, params, rope = engine.cfg, engine.params, engine.rope
    int8 = is_int8(engine)
    name = "fused_slow_step_int8" if int8 else "fused_slow_step"
    tag, phase = (f"{label}: {name}", "versions") if label else (name, "kernels")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    n_layer, kv, hd, s = cfg.n_layer, cfg.n_local_heads, cfg.head_dim, engine.cache_len

    def inputs(positions):
        b = len(positions)
        ids = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=dev)
        shape = (n_layer, b, kv, s, hd)
        rnd = lambda: (torch.randn(shape, generator=gen, device=dev) * 0.5).to(torch.bfloat16)  # noqa: E731
        return (params["embeddings"][ids].contiguous(),
                torch.tensor(positions, dtype=torch.int32, device=dev), rnd(), rnd())

    worst, pool, h0 = {}, [], held_dims(params)
    for positions in ((0,), (1,), (104,), (s - 1,), (0, 1), (104, s - 1), (3, 40, 200, s - 1)):
        x0, pos, ck, cv = inputs(positions)
        ckp, cvp, ck32, cv32 = ck.clone(), cv.clone(), ck.float(), cv.float()
        got_l, got_h = ss.fused_slow_step(params, cfg, x0, pos, ck, cv, rope)
        pl_l, pl_h = ss.fused_slow_step_plain(params, cfg, x0, pos, ckp, cvp, rope)
        ref_l, ref_h = ss.fused_slow_step_plain(params32, cfg, x0.float(), pos, ck32, cv32, rope)
        torch.cuda.synchronize()
        what = f"{tag} pos={positions}"
        check(bool(torch.isfinite(got_l).all()), f"{what}: non-finite logits")
        rows, p = torch.arange(len(positions), device=dev), pos.long()
        errs = step_errors(torch, what, ((got_l, got_h), (pl_l, pl_h), (ref_l, ref_h)),
                           ((ck, cv), (ckp, cvp), (ck32, cv32)), rows, p, h0, pool)
        vs_plain = float((got_l - pl_l).abs().max())
        h_ulp, _ = within_ulp(torch, got_h, pl_h)
        argmax = [got_l.argmax(-1).tolist(), pl_l.argmax(-1).tolist(), ref_l.argmax(-1).tolist()]
        for k, v in errs.items():
            worst[k] = max(worst.get(k, (0.0, 0.0)), v)
        worst["vs_plain"] = max(worst.get("vs_plain", 0.0), vs_plain)
        log(phase, f"{what}: max abs distance to the float32 evaluation, kernel | plain: "
            + ", ".join(f"{k} {a:.4f} | {b:.4f}" for k, (a, b) in errs.items())
            + f"; other cache rows bit-equal; kernel vs plain: logits {vs_plain:.4f}, hidden "
            f"{h_ulp:.0f} bf16 ulp at worst; argmax kernel/plain/float32 {argmax}")

    small = pooled_logits(torch, tag, pool, phase)
    if small is not None:
        worst["logits"] = small

    # how far one rounding flip spreads: one layer, kernel vs plain
    one = dataclasses.replace(cfg, n_layer=1)
    one_params = dict(params, slow=first_layers(params["slow"], 1))
    spread = []
    for _ in range(4):
        x0, pos, ck, cv = inputs((main_pos,))
        ck, cv = ck[:1].contiguous(), cv[:1].contiguous()
        got_h = ss.fused_slow_step(one_params, one, x0, pos, ck, cv, rope)[1]
        pl_h = ss.fused_slow_step_plain(one_params, one, x0, pos, ck.clone(), cv.clone(), rope)[1]
        spread.append(int((got_h != pl_h).sum()))
    log(phase, f"{tag}, one layer at pos {main_pos}, 4 inputs: hidden elements "
        f"differing from the plain version {spread} of {cfg.dim}")

    x0, pos, ck, cv = inputs((main_pos,))
    kernel = lambda: ss.fused_slow_step(params, cfg, x0, pos, ck, cv, rope)  # noqa: E731
    ms = device_ms(torch, kernel, calls=20, replays=5)
    call_ms = eager_ms(torch, kernel, 20)
    plain_ms = device_ms(
        torch, lambda: ss.fused_slow_step_plain(params, cfg, x0, pos, ck, cv, rope),
        calls=3, replays=3)
    d, w = cfg.dim, params["output"].shape[1]
    weights = n_layer * layer_elems(cfg) + d + d * w

    def step_bound(p):
        # bytes: weights (int8 ones with their scales), x0, pos, the rope
        # rows and K/V rows 0..p-1 read once; the new K/V rows, logits and
        # hidden written once
        nbytes = (n_layer * layer_bytes(cfg, int8) + 2 * (d + d * w) + 2 * d + 4 + 4 * hd
                  + 2 * n_layer * 2 * kv * p * hd + 2 * n_layer * 2 * kv * hd + 4 * w + 2 * d)
        flops = 2 * (weights - (2 * n_layer + 1) * d) + n_layer * 4 * cfg.n_head * (p + 1) * hd
        return (*bound(nbytes, flops), nbytes)

    bound_ms, bound_by, nbytes = step_bound(main_pos)
    log(phase, f"{tag} B=1 pos={main_pos}: kernel {ms:.4f} ms (eager call "
        f"{call_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}, "
        f"{nbytes / 1e6:.1f} MB)")
    # long caches: the last position at which each block computes every
    # rank itself, the first whose attention is split over a head's
    # blocks, and the cache's last
    long_ms = {}
    split_keys = ds.SPLIT_TILES * ds.KV_TILE
    for p_long in (split_keys - 1, split_keys, s - 1):
        x0l, posl, ckl, cvl = inputs((p_long,))
        long_ms[p_long] = device_ms(
            torch, lambda: ss.fused_slow_step(params, cfg, x0l, posl, ckl, cvl, rope),
            calls=20, replays=5)
        b_ms = step_bound(p_long)[0]
        log(phase, f"{tag} B=1 pos={p_long}: kernel {long_ms[p_long]:.4f} ms, bound "
            f"{b_ms:.6f} ms ({100 * b_ms / long_ms[p_long]:.1f}% of it)")
    contract = check_stack_contract(torch, engine, False, tag, ms, bound_ms, phase)
    return {**contract,
        "name": name, "route": "cuda",
        "source": "fish_speech_tpu_torch/csrc/slow_step.cu",
        "replaces": "fish_speech_tpu/ops/slow_step_pallas.py:" + ("152" if int8 else "447"),
        "max_abs_err": worst["vs_plain"],
        "err_vs_float32": {k: list(v) for k, v in worst.items() if k != "vs_plain"},
        "ms": ms, "kernel_ms": ms, "eager_call_ms": call_ms,
        "kernel_ms_at_pos": {str(k): v for k, v in long_ms.items()},
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "shape": f"x0 (1,{d}), {n_layer} layers ({'int8' if int8 else 'bf16'}), head "
                 f"({d},{w}), cache ({n_layer},1,{kv},{s},{hd}) bf16, pos {main_pos}",
    }


def check_stack_contract(torch, engine, fast: bool, name: str, ms: float, bound_ms: float,
                         phase: str = "kernels") -> dict:
    """The persistent kernel's contract on the card (csrc/decode_stack.cuh):
    its plan as built equals ops/decode_stack.py's mirror; one launch a
    call (a fast frame: a persistent and a sampler launch a codebook step)
    and the grid syncs and key-split exchanges of a launch, all counted by
    the kernels themselves, equal to the plan's;
    five repeated calls bit-identical; a CUDA graph's replay equal to the
    eager call; the call completes while a long kernel holds an SM on a
    second stream; for the slow step (four rows, one past the key-split
    threshold), a row alone bit-equal to the same row among four. Returns
    the plan's and the measured numbers for the kernels line."""

    from fish_speech_tpu_torch.ops import decode_stack as ds
    from fish_speech_tpu_torch.ops import fast_frame as ff
    from fish_speech_tpu_torch.ops import slow_step as ss
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs, gumbel_noise, top_k_width

    cfg, params, rope = engine.cfg, engine.params, engine.rope
    int8 = is_int8(engine)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    grid = ds.grid_of(dev)
    if fast:
        mirror = ff.fast_plan(cfg, int8, grid)
        card = ds.plan_on_card(ds.FAST, cfg.dim, cfg.n_head, cfg.n_local_heads,
                               cfg.intermediate_size, cfg.codebook_size, cfg.num_codebooks, int8)
        n_layer, steps = cfg.n_fast_layer, cfg.num_codebooks
        sampling = SamplingArgs(**SAMPLING)
        hidden = torch.randn((1, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
        window = torch.randint(-1, cfg.codebook_size, (steps, 16), generator=gen, device=dev,
                               dtype=torch.int32)
        gumbel = gumbel_noise((steps, top_k_width(sampling.top_k, cfg.codebook_size)), gen, dev)
        eos = torch.tensor([False], device=dev)

        def call():
            return ff.fused_fast_frame(params, cfg, sampling, hidden, window, gumbel, eos, rope,
                                       rep_enabled=not cfg.depthwise_wte, return_logits=True)
        counter = ff
    else:
        head_cols, s = params["output"].shape[1], engine.cache_len
        mirror = ss.slow_plan(cfg, head_cols, s, int8, grid)
        card = ds.plan_on_card(ds.SLOW, cfg.dim, cfg.n_head, cfg.n_local_heads,
                               cfg.intermediate_size, head_cols, s, int8)
        n_layer, steps = cfg.n_layer, 1
        positions = (104, 3, s - 1, 40)
        ids = torch.randint(0, cfg.vocab_size, (4,), generator=gen, device=dev)
        x0 = params["embeddings"][ids].contiguous()
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        shape = (n_layer, 4, cfg.n_local_heads, s, cfg.head_dim)
        ck0, cv0 = ((torch.randn(shape, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
                    for _ in range(2))
        ck, cv = ck0.clone(), cv0.clone()

        def call(rows=slice(0, 4), caches=None):
            k, v = caches if caches is not None else (ck0[:, rows].clone(), cv0[:, rows].clone())
            out = ss.fused_slow_step(params, cfg, x0[rows].clone(), pos[rows].clone(),
                                     k, v, rope)
            return (*out, k, v)
        counter = ss
    check(card == mirror, f"{name}: the plan on the card {card} differs from the mirror {mirror}")
    kind = ds.FAST if fast else ds.SLOW
    syncs = mirror.syncs_per_launch(kind, n_layer)
    exchanges = mirror.kv_exchanges(n_layer, [] if fast else positions)

    before, on_card = counter.launches, ds.launch_counts(dev)
    outs = [call() for _ in range(5)]
    torch.cuda.synchronize()
    launched, sampled = (a - b for a, b in zip(ds.launch_counts(dev), on_card))
    card_syncs, card_exchanges = ds.last_call_counts(dev)
    check(counter.launches - before == 5, f"{name}: {counter.launches - before} calls counted "
          "in 5 calls")
    check((launched, sampled) == (5 * steps, 5 * steps if fast else 0),
          f"{name}: the kernels counted {launched} persistent and {sampled} sampler launches in "
          "5 calls")
    check((card_syncs, card_exchanges) == (syncs, exchanges),
          f"{name}: the kernel counted {card_syncs} grid syncs and {card_exchanges} key-split "
          f"exchanges a launch, the plan {syncs} and {exchanges}")
    same = all(torch.equal(a, b) for o in outs[1:] for a, b in zip(o, outs[0]))
    check(same, f"{name}: five repeated calls are not bit-identical")

    # a CUDA graph's replay against the eager call (the slow step's graph
    # writes its own cache copies, reset before each replay)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = call() if fast else call(caches=(ck, cv))
    for _ in range(3):
        if not fast:
            ck.copy_(ck0)
            cv.copy_(cv0)
        graph.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(captured, outs[0])),
              f"{name}: a CUDA graph's replay differs from the eager call")

    # beside a long kernel on another stream: the launch waits, no deadlock
    other = torch.cuda.Stream()
    with torch.cuda.stream(other):
        torch.cuda._sleep(400_000_000)  # ~0.2 s of one spinning block
    t0 = time.perf_counter()
    got = call()
    torch.cuda.synchronize()
    beside_s = time.perf_counter() - t0
    check(all(torch.equal(a, b) for a, b in zip(got, outs[0])),
          f"{name}: the call beside a second stream's kernel differs")

    alone = ""
    if not fast:
        four = call(rows=slice(0, 4))
        for r in range(4):
            one = call(rows=slice(r, r + 1))
            check(torch.equal(one[0][0], four[0][r]) and torch.equal(one[1][0], four[1][r])
                  and torch.equal(one[2][:, 0], four[2][:, r])
                  and torch.equal(one[3][:, 0], four[3][:, r]),
                  f"{name}: row {r} (pos {positions[r]}) alone differs from the same row among 4")
        alone = "; each of 4 rows (pos 104, 3, cache-1, 40) alone bit-equal to itself among 4"
    log(phase, f"{name} persistent kernel: plan on the card equal to the mirror (grid "
        f"{mirror.grid} x {ds.BLOCK_THREADS} threads, {mirror.smem} B of shared memory a block, "
        f"ring of {mirror.stages} stages x {ds.THREADS * mirror.piece_bytes} B, QKV {mirror.qkv_tiles}"
        f"x{mirror.qkv_splits} units, attention+wo {mirror.attn_units}, w1/w3+w2 "
        f"{mirror.sw_units} ({mirror.sw_split}-way K-split)); counted on the card: "
        f"{card_syncs} grid syncs a launch ({mirror.syncs_per_layer} a layer) and "
        f"{card_exchanges} key-split exchanges a head a launch (positions "
        f"{list(range(steps)) if fast else list(positions)}); {launched // 5} persistent and "
        f"{sampled // 5} sampler launches a call; 5 calls bit-identical; CUDA "
        f"graph replay equal to eager; completes beside a kernel on a second stream "
        f"({beside_s:.3f} s including the wait){alone}; kernel {ms:.4f} ms against the bound "
        f"{bound_ms:.6f} ms: {100 * bound_ms / ms:.1f}% of the bound")
    return {"grid": mirror.grid, "smem": mirror.smem, "ring_stages": mirror.stages,
            "syncs_per_call": card_syncs * (launched // 5),
            "kv_exchanges_per_call": card_exchanges * (launched // 5),
            "launches_per_call": (launched + sampled) // 5,
            "share_of_bound": bound_ms / ms}


def rows_bound(cfg, int8: bool, head_cols: int, positions):
    """(ms, "bytes" or "operations", bytes) of one slow step of len(positions)
    rows: the weights (int8 ones with their scales), the final norm and
    the head read once; each row's x0, pos, RoPE rows and K/V rows 0..p-1
    read once; its new K/V rows, logits and hidden written once."""
    n_layer, d, kv, hd = cfg.n_layer, cfg.dim, cfg.n_local_heads, cfg.head_dim
    weights = n_layer * layer_elems(cfg) + d + d * head_cols
    nbytes = n_layer * layer_bytes(cfg, int8) + 2 * (d + d * head_cols)
    flops = 0
    for p in positions:
        nbytes += (2 * d + 4 + 4 * hd + 2 * n_layer * 2 * kv * p * hd + 2 * n_layer * 2 * kv * hd
                   + 4 * head_cols + 2 * d)
        flops += 2 * (weights - (2 * n_layer + 1) * d) + n_layer * 4 * cfg.n_head * (p + 1) * hd
    return (*bound(nbytes, flops), nbytes)


def device_kernels(prof, regions=()) -> list:
    """The CUDA kernels of a torch.profiler run, with their device time;
    the device-side spans of the named `regions` (annotate) are left out."""
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")
            and getattr(e, "self_device_time_total", 0) > 0 and e.key not in regions]


def log_top_kernels(phase: str, kernels, n: int, unit: str, top: int = 8) -> None:
    """The `top` kernels by device time, per `unit` of the n profiled."""
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(phase, f"  {e.self_device_time_total / 1e3 / n:8.4f} ms/{unit} "
            f"{e.count / n:6.1f}x  {e.key[:90]}")


def check_slow_step_rows(torch, engine, params32, label: str = "") -> dict:
    """The fused slow step's row kernel (csrc/slow_step_rows.cu, one
    persistent launch a group of 32 rows), which the serving engine's
    `auto` runs at 16 rows: its plan as built against the mirror
    (`ops/decode_stack.py::rows_plan`); at B = 16, cache 512 and serving
    positions 39-167, at B = 32 and 64 (two launches) on cache 256 and at
    8 rows of cache 2048 past 1024 keys, each held to the plain version's
    distance to a float32 evaluation (as the persistent kernel is) with the
    other cache rows bit-equal, one launch a group as the C entry and the
    kernel count them, and the kernel's own count of its grid syncs and
    head 0's exchanges equal to the plan's; each of 16 rows alone
    (`rows_step`, one row) bit-equal to itself among 16; then timed in a
    CUDA graph against the byte bound, beside the plain version and the
    unfused step (`models/dual_ar.py::slow_decode_step`, the path it
    replaces)."""
    from fish_speech_tpu_torch.models.dual_ar import KVCache, slow_decode_step
    from fish_speech_tpu_torch.ops import decode_stack as ds
    from fish_speech_tpu_torch.ops import slow_step as ss

    cfg, params, rope = engine.cfg, engine.params, engine.rope
    int8 = is_int8(engine)
    name = "slow_step_rows_int8" if int8 else "slow_step_rows"
    tag, phase = (f"{label}: {name}", "versions") if label else (name, "kernels")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    n_layer, kv, hd = cfg.n_layer, cfg.n_local_heads, cfg.head_dim
    head_cols = params["output"].shape[1]
    head_rows = engine.rows_head
    check(head_rows is not None and tuple(head_rows.shape) == (cfg.dim, ss.head_stride(head_cols))
          and torch.equal(head_rows[:, :head_cols], params["output"])
          and not bool(head_rows[:, head_cols:].any()),
          f"{tag}: the engine's padded head {None if head_rows is None else head_rows.shape}")
    plans = {}
    for s_len in (SERVE_CACHE, 256, 2048):
        mirror = ss.rows_plan(cfg, head_cols, s_len, int8, ds.grid_of(dev))
        card = ds.rows_plan_on_card(cfg.dim, cfg.n_head, kv, cfg.intermediate_size, head_cols,
                                    s_len, int8)
        check(mirror is not None and card == mirror,
              f"{tag}: the plan on the card {card} differs from the mirror {mirror} at cache "
              f"{s_len}")
        plans[s_len] = mirror
    plan = plans[SERVE_CACHE]
    syncs, exchanges = plan.syncs_per_launch(n_layer), plan.head_exchanges(n_layer)

    def inputs(b, s, positions=None):
        if positions is None:  # the serving positions: 39 (a 40-token prompt) to 167
            positions = torch.randperm(129, generator=gen, device=dev)[:b] + 39
        ids = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=dev)
        shape = (n_layer, b, kv, s, hd)
        rnd = lambda: (torch.randn(shape, generator=gen, device=dev) * 0.5).to(torch.bfloat16)  # noqa: E731
        return (params["embeddings"][ids].contiguous(),
                torch.as_tensor(positions, device=dev).to(torch.int32), rnd(), rnd())

    worst, pool, h0 = {}, [], held_dims(params)
    # serving; one group of 32; two groups; and 8 rows of a cache whose
    # keys past 1024 lie beyond the first 4 steps of a rank's tiles
    cases = ((16, SERVE_CACHE, None), (32, 256, [(37 * i + 5) % 256 for i in range(31)] + [255]),
             (64, 256, [(53 * i + 11) % 256 for i in range(63)] + [255]),
             (8, 2048, [0, 255, 256, 1023, 1024, 1500, 2000, 2047]))
    for b, s, positions in cases:
        x0, pos, ck, cv = inputs(b, s, positions)
        ckp, cvp, ck32, cv32 = ck.clone(), cv.clone(), ck.float(), cv.float()
        before, before8 = ss.rows_launches, ss.rows_int8_launches
        on_card = ds.rows_launch_count(dev)
        got_l, got_h = ss.fused_slow_step(params, cfg, x0, pos, ck, cv, rope, head_rows=head_rows)
        launched = ss.rows_launches - before
        launched8 = ss.rows_int8_launches - before8
        counted = ds.rows_launch_count(dev) - on_card
        card_syncs, card_exchanges = ds.last_call_counts(dev)
        pl_l, pl_h = ss.fused_slow_step_plain(params, cfg, x0, pos, ckp, cvp, rope)
        ref_l, ref_h = ss.fused_slow_step_plain(params32, cfg, x0.float(), pos, ck32, cv32, rope)
        torch.cuda.synchronize()
        what = f"{tag} B={b} cache {s}"
        want = ss.rows_launches_per_step(n_layer, b)
        check(launched == want and launched8 == (want if int8 else 0) and counted == want,
              f"{what}: the C entry counted {launched} launches ({launched8} int8), the kernel "
              f"{counted}, the mirror {want}")
        want_syncs = plans[s].syncs_per_launch(n_layer), plans[s].head_exchanges(n_layer)
        check((card_syncs, card_exchanges) == want_syncs,
              f"{what}: the kernel counted {card_syncs} grid syncs and {card_exchanges} head "
              f"exchanges a launch, the plan {want_syncs}")
        check(tuple(got_l.shape) == (b, head_cols) and bool(torch.isfinite(got_l).all()),
              f"{what}: logits {tuple(got_l.shape)} not finite or misshaped")
        rows, p = torch.arange(b, device=dev), pos.long()
        errs = step_errors(torch, what, ((got_l, got_h), (pl_l, pl_h), (ref_l, ref_h)),
                           ((ck, cv), (ckp, cvp), (ck32, cv32)), rows, p, h0, pool)
        vs_plain = float((got_l - pl_l).abs().max())
        for k, v in errs.items():
            worst[k] = max(worst.get(k, (0.0, 0.0)), v)
        worst["vs_plain"] = max(worst.get("vs_plain", 0.0), vs_plain)
        log(phase, f"{what}: {launched} launches (one a group of <= {ss.ROWS_GROUP} rows, "
            f"counted by the C entry and by the kernel), {card_syncs} grid syncs and "
            f"{card_exchanges} head exchanges a launch (counted by the kernel); max abs distance "
            "to the float32 evaluation, kernel | plain: "
            + ", ".join(f"{k} {a:.4f} | {c:.4f}" for k, (a, c) in errs.items())
            + f"; other cache rows bit-equal; kernel vs plain: logits {vs_plain:.4f}")

    small = pooled_logits(torch, tag, pool, phase)
    if small is not None:
        worst["logits"] = small

    # a row alone through the same kernel, bit-equal to itself among 16
    x0, pos, ck, cv = inputs(SERVE_ROWS, SERVE_CACHE)
    k16, v16 = ck.clone(), cv.clone()
    l16, h16 = ss.fused_slow_step(params, cfg, x0, pos, k16, v16, rope, head_rows=head_rows)
    for r in range(SERVE_ROWS):
        k1, v1 = ck[:, r:r + 1].contiguous(), cv[:, r:r + 1].contiguous()
        l1, h1 = ss.rows_step(params, cfg, x0[r:r + 1].clone(), pos[r:r + 1].clone(), k1, v1,
                              rope, head_rows=head_rows)
        check(torch.equal(l1[0], l16[r]) and torch.equal(h1[0], h16[r])
              and torch.equal(k1[:, 0], k16[:, r]) and torch.equal(v1[:, 0], v16[:, r]),
              f"{tag}: row {r} (pos {int(pos[r])}) alone differs from the same row among 16")
    log(phase, f"{tag}: each of {SERVE_ROWS} rows alone bit-equal to itself among "
        f"{SERVE_ROWS} (logits, hidden, its cache rows)")

    kernel = lambda: ss.fused_slow_step(params, cfg, x0, pos, ck, cv, rope,  # noqa: E731
                                        head_rows=head_rows)
    ms = device_ms(torch, kernel, calls=10, replays=5)
    call_ms = eager_ms(torch, kernel, 10)
    plain_ms = device_ms(
        torch, lambda: ss.fused_slow_step_plain(params, cfg, x0, pos, ck, cv, rope),
        calls=2, replays=3)
    prev = torch.randint(0, cfg.codebook_size, (SERVE_ROWS, cfg.num_codebooks + 1),
                         generator=gen, device=dev, dtype=torch.int32)
    cache = KVCache(k=ck, v=cv)
    unfused_ms = device_ms(
        torch, lambda: slow_decode_step(params, cfg, engine.token_cfg, prev, cache, pos, rope),
        calls=3, replays=3)
    bound_ms, bound_by, nbytes = rows_bound(cfg, int8, head_cols, pos.tolist())
    times = {}
    for b, s, positions in cases[1:3]:
        xb, posb, ckb, cvb = inputs(b, s, positions)
        times[b] = device_ms(torch, lambda: ss.fused_slow_step(
            params, cfg, xb, posb, ckb, cvb, rope, head_rows=head_rows), calls=5, replays=3)
        b_ms = rows_bound(cfg, int8, head_cols, posb.tolist())[0]
        log(phase, f"{tag} B={b} cache {s}: kernel {times[b]:.4f} ms, bound {b_ms:.6f} ms "
            f"({100 * b_ms / times[b]:.1f}% of it)")
    # where a step's device time goes, by kernel
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            kernel()
        torch.cuda.synchronize()
    log(phase, f"{tag} B={SERVE_ROWS}: a step's kernels under torch.profiler (3 steps):")
    log_top_kernels("kernels", device_kernels(prof), 3, "step", top=6)
    per_step = ss.rows_launches_per_step(n_layer, SERVE_ROWS)
    log(phase, f"{tag} row kernel: plan on the card equal to the mirror at caches "
        f"{sorted(plans)} (grid {plan.grid} x {ds.BLOCK_THREADS} threads, {plan.smem} B of shared "
        f"memory a block, ring of {plan.stages} stages x {plan.stage_bytes} B, QKV "
        f"{plan.qkv_tiles}x{plan.qkv_splits} units, attention+wo {plan.attn_units} "
        f"({plan.attn_ranks} ranks a row), w1/w3+w2 {plan.sw_units} ({plan.sw_split}-way "
        f"K-split), {plan.owners} owners of x)")
    log(phase, f"{tag} B={SERVE_ROWS} cache {SERVE_CACHE} pos 39-167 ({n_layer} layers, "
        f"{'int8' if int8 else 'bf16'}, {per_step} launch a step, {syncs} grid syncs): kernel "
        f"{ms:.4f} ms (eager call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, unfused step "
        f"(slow_decode_step) {unfused_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}, "
        f"{nbytes / 1e6:.1f} MB): {100 * bound_ms / ms:.1f}% of the bound")
    return {
        "name": name, "route": "cuda",
        "source": "fish_speech_tpu_torch/csrc/slow_step_rows.cu",
        "replaces": "fish_speech_tpu/ops/slow_step_pallas.py:" + ("152" if int8 else "447"),
        "max_abs_err": worst["vs_plain"],
        "err_vs_float32": {k: list(v) for k, v in worst.items() if k != "vs_plain"},
        "ms": ms, "kernel_ms": ms, "eager_call_ms": call_ms,
        "kernel_ms_at_batch": {str(k): v for k, v in times.items()},
        "plain_ms": plain_ms, "unfused_step_ms": unfused_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "share_of_bound": bound_ms / ms, "library_ms": None,
        "launches_per_step": per_step, "grid": plan.grid, "smem": plan.smem,
        "ring_stages": plan.stages, "syncs_per_call": syncs, "head_exchanges_per_call": exchanges,
        "shape": f"x0 ({SERVE_ROWS},{cfg.dim}), {n_layer} layers ({'int8' if int8 else 'bf16'}), "
                 f"head ({cfg.dim},{head_cols}) padded to {ss.head_stride(head_cols)}, cache "
                 f"({n_layer},{SERVE_ROWS},{kv},{SERVE_CACHE},{hd}) bf16, pos 39-167",
    }


def exact_fast_params(torch, params, cfg):
    """Fast-frame parameters whose every sum is exact: zero layer
    weights (each layer is then the identity on x; int8 ones quantize to
    q = 0, s = bf16(1e-8)) and one-hot embedding rows; the head stays."""
    from fish_speech_tpu_torch.ops.quant import is_quantized, quantize_weight

    def zero(v):
        if is_quantized(v):
            return quantize_weight(torch.zeros_like(v["q"], dtype=torch.bfloat16))
        return torch.zeros_like(v)

    out = dict(params)
    out["fast"] = {k: (v if k.endswith("norm") else zero(v)) for k, v in params["fast"].items()}
    emb = torch.zeros_like(params["fast_embeddings"])
    rows = torch.arange(emb.shape[0], device=emb.device)
    emb[rows, rows % cfg.dim] = 1
    out["fast_embeddings"] = emb
    return out


def check_fast_frame(torch, engine, params32, label: str = ""):
    from fish_speech_tpu_torch.ops import fast_frame as ff
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs, gumbel_noise, top_k_width

    cfg, params, rope = engine.cfg, engine.params, engine.rope
    int8 = is_int8(engine)
    name = "fused_fast_frame_int8" if int8 else "fused_fast_frame"
    tag, phase = (f"{label}: {name}", "versions") if label else (name, "kernels")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    n_cb, vocab, d = cfg.num_codebooks, cfg.codebook_size, cfg.dim
    rep = not cfg.depthwise_wte  # the codebook rep-pen, off under depthwise_wte as engines run it

    def inputs(sampling, eos=False, one_hot=False):
        if one_hot:
            j = int(torch.randint(0, d, (1,), generator=gen, device=dev))
            hidden = torch.zeros((1, d), dtype=torch.bfloat16, device=dev)
            hidden[0, j] = 1
        else:
            hidden = torch.randn((1, d), generator=gen, device=dev).to(torch.bfloat16)
        return (hidden,
                torch.randint(-1, vocab, (n_cb, 16), generator=gen, device=dev,
                              dtype=torch.int32),
                None if sampling.is_argmax else gumbel_noise(
                    (n_cb, top_k_width(sampling.top_k, vocab)), gen, dev),
                torch.tensor([eos], device=dev))

    # 1. tokens exactly equal where every sum is exact
    exact = exact_fast_params(torch, params, cfg)
    sampled = SamplingArgs(**SAMPLING)
    cases = (("sampled", sampled, rep, False, FAST_FRAMES),
             ("argmax", SamplingArgs(temp=0.0, top_p=1.0, top_k=vocab,
                                     repetition_penalty=1.4), rep, False, 8),
             ("no rep-pen", SamplingArgs(temp=0.7, top_p=0.8, top_k=256,
                                         repetition_penalty=1.0), False, False, 8),
             ("is_eos", sampled, rep, True, 4))
    for case, sampling, case_rep, eos, frames in cases:
        n_diff = n_tied = 0
        for _ in range(frames):
            hidden, window, gumbel, is_eos = inputs(sampling, eos, one_hot=True)
            got, got_l = ff.fused_fast_frame(exact, cfg, sampling, hidden, window, gumbel, is_eos,
                                             rope, rep_enabled=case_rep, return_logits=True)
            ref, ref_l = ff.fused_fast_frame_plain(exact, cfg, sampling, hidden, window, gumbel,
                                                   is_eos, rope, rep_enabled=case_rep,
                                                   return_logits=True)
            check(torch.equal(got_l, ref_l), f"{tag} {case}: exact logits differ")
            n_diff += int((got != ref).sum())
            n_tied += sum(vocab - len(torch.unique(row)) for row in ref_l)
            if eos:
                check(not bool(got.any()), f"{tag} is_eos: tokens are not all 0")
        check(n_diff == 0, f"{tag} {case}: {n_diff} of {frames * n_cb} tokens "
              f"differ from the plain version")
        log(phase, f"{tag} exact inputs, {case} ({sampling}, rep_enabled={case_rep}): "
            f"{frames * n_cb} tokens over {frames} frames equal to the plain version "
            f"(logits bit-equal, {n_tied} tied logit values)")

    # 2. accuracy of each step's logits at full weights, steps up to the
    #    first one whose input token differs among kernel, plain, float32
    argmax = SamplingArgs(temp=0.0, top_p=1.0, top_k=vocab, repetition_penalty=1.4)
    err_k = err_p = vs_plain = 0.0
    steps = same_tokens = 0
    for _ in range(FAST_FRAMES):
        hidden, window, _, is_eos = inputs(argmax)
        args = (cfg, argmax, hidden, window, None, is_eos, rope)
        tk, lk = ff.fused_fast_frame(params, *args, rep_enabled=rep, return_logits=True)
        tp, lp = ff.fused_fast_frame_plain(params, *args, rep_enabled=rep, return_logits=True)
        tr, lr = ff.fused_fast_frame_plain(params32, cfg, argmax, hidden.float(), window, None,
                                           is_eos, rope, rep_enabled=rep, return_logits=True)
        differ = ((tk != tp) | (tk != tr)).nonzero()
        n = n_cb if len(differ) == 0 else int(differ[0]) + 1
        steps += n
        same_tokens += int((tk == tp).sum())
        err_k = max(err_k, float((lk[:n] - lr[:n]).abs().max()))
        err_p = max(err_p, float((lp[:n] - lr[:n]).abs().max()))
        vs_plain = max(vs_plain, float((lk[:n] - lp[:n]).abs().max()))
    check(err_k <= ACCURACY_FACTOR * err_p + 1e-6,
          f"{tag} step logits: {err_k:.4e} from the float32 evaluation, plain "
          f"version {err_p:.4e}")
    log(phase, f"{tag} full weights, argmax, {FAST_FRAMES} frames: step logits "
        f"over {steps} steps, max abs distance to the float32 evaluation kernel {err_k:.4f} | "
        f"plain {err_p:.4f}, kernel vs plain {vs_plain:.4f}; tokens equal to the plain "
        f"version {same_tokens} of {FAST_FRAMES * n_cb}")

    # sampled tokens at full weights follow the rank order, which any
    # difference in summation reshuffles: reported, not checked
    same_kp = same_pr = 0
    for _ in range(8):
        args = (cfg, sampled, *inputs(sampled), rope)
        tk = ff.fused_fast_frame(params, *args, rep_enabled=rep)
        tp = ff.fused_fast_frame_plain(params, *args, rep_enabled=rep)
        h, w, g, e, _ = args[2:]
        tr = ff.fused_fast_frame_plain(params32, cfg, sampled, h.float(), w, g, e, rope,
                                       rep_enabled=rep)
        same_kp += int((tk == tp).sum())
        same_pr += int((tp == tr).sum())
    log(phase, f"{tag} full weights, sampled, 8 frames: tokens equal kernel vs "
        f"plain {same_kp} of {8 * n_cb}, plain vs float32 evaluation {same_pr} of {8 * n_cb}")

    hidden, window, gumbel, is_eos = inputs(sampled)
    kernel = lambda: ff.fused_fast_frame(params, cfg, sampled, hidden, window, gumbel,  # noqa: E731
                                         is_eos, rope, rep_enabled=rep)
    ms = device_ms(torch, kernel, calls=10, replays=5)
    call_ms = eager_ms(torch, kernel, 20)
    plain_ms = device_ms(
        torch, lambda: ff.fused_fast_frame_plain(params, cfg, sampled, hidden, window, gumbel,
                                                 is_eos, rope, rep_enabled=rep),
        calls=2, replays=3)
    n_layer, k_eff = cfg.n_fast_layer, gumbel.shape[1]
    weights = n_layer * layer_elems(cfg) + d + d * vocab
    wbytes, step_bytes = fast_weight_bytes(cfg, int8)
    # read once: the weights (int8 ones with their scales) and head,
    # hidden, the C-1 embedding rows gathered, windows, noise, is_eos;
    # written: the C tokens. The re-read floor streams a step's weights
    # and head at every step.
    once = wbytes + 2 * d + 2 * d * (n_cb - 1) + 4 * n_cb * 16 + 4 * n_cb * k_eff + 1 + 4 * n_cb
    reread = once + n_cb * step_bytes - wbytes
    flops = n_cb * 2 * (weights - (2 * n_layer + 1) * d)
    bound_ms, bound_by = bound(once, flops)
    reread_ms, _ = bound(reread, flops)
    log(phase, f"{tag} ({n_cb} steps x {n_layer} layers): kernel {ms:.4f} ms "
        f"(eager call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}, read once, {once / 1e6:.1f} MB), re-read floor {reread_ms:.6f} ms "
        f"({reread / 1e6:.1f} MB)")
    contract = check_stack_contract(torch, engine, True, tag, ms, reread_ms, phase)
    return {**contract,
        "name": name, "route": "cuda",
        "source": "fish_speech_tpu_torch/csrc/fast_frame.cu",
        "replaces": "fish_speech_tpu/ops/fast_frame_pallas.py:" + ("127" if int8 else "495"),
        "max_abs_err": vs_plain, "err_vs_float32": [err_k, err_p],
        "ms": ms, "kernel_ms": ms, "eager_call_ms": call_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_reread_ms": reread_ms, "library_ms": None,
        "shape": f"hidden (1,{d}), {n_cb} codebooks x {n_layer} layers "
                 f"({'int8' if int8 else 'bf16'}), vocab {vocab}, k_eff {k_eff}, window 16",
    }


def batched_inputs(torch, cfg, gen, b: int, k_dyn: int, mode: str, one_hot: bool):
    """Inputs of one batched fast frame: hidden rows, rep-pen windows,
    Gumbel draws by rank, per-row knobs and EOS flags. mode: "argmax"
    (every row at temp 0), "sampled" (the serving knobs) or "mixed"
    (rows differ in every knob; row 1 argmax, row 2 EOS)."""
    from fish_speech_tpu_torch.ops.sampling import RowSampling, gumbel_noise

    dev = gen.device
    d, n_cb, vocab = cfg.dim, cfg.num_codebooks, cfg.codebook_size
    if one_hot:
        hidden = torch.zeros((b, d), dtype=torch.bfloat16, device=dev)
        hidden[torch.arange(b, device=dev),
               torch.randint(0, d, (b,), generator=gen, device=dev)] = 1
    else:
        hidden = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
    window = torch.randint(-1, vocab, (b, n_cb, 12), generator=gen, device=dev,
                           dtype=torch.int32)
    gumbel = gumbel_noise((b, n_cb, k_dyn), gen, dev)
    if mode == "mixed":
        knobs = [[0.7, 0.0, 1.2, 0.5], [0.8, 1.0, 0.6, 0.95], [256, 0, 16, 64],
                 [1.4, 1.0, 1.5, 1.1]]
        vecs = torch.tensor([[k[i % 4] for k in knobs] for i in range(b)], dtype=torch.float32)
    else:
        temp = 0.0 if mode == "argmax" else SAMPLING["temp"]
        vecs = torch.tensor([[temp, SAMPLING["top_p"], SAMPLING["top_k"],
                              SAMPLING["repetition_penalty"]]] * b, dtype=torch.float32)
    is_eos = torch.zeros((b,), dtype=torch.bool, device=dev)
    if mode == "mixed":
        is_eos[2] = True
    return (RowSampling.from_vectors(vecs.to(dev)), hidden, window, gumbel, is_eos)


def check_fast_frame_batched(torch, engine, params32, label: str = ""):
    from fish_speech_tpu_torch.ops import fast_frame_batched as fb

    cfg, params, rope = engine.cfg, engine.params, engine.rope
    int8 = is_int8(engine)
    name = "fused_fast_frame_batched_int8" if int8 else "fused_fast_frame_batched"
    tag, phase = (f"{label}: {name}", "versions") if label else (name, "kernels")
    gen = torch.Generator(device=torch.device("cuda"))
    gen.manual_seed(55)
    n_cb, vocab, d, b = cfg.num_codebooks, cfg.codebook_size, cfg.dim, engine.batch_size
    k_dyn = min(engine.dyn_top_k_cap, vocab)
    rep = not cfg.depthwise_wte  # the codebook rep-pen, off under depthwise_wte as engines run it

    # 1. tokens and step logits bit-equal where every sum is exact
    exact = exact_fast_params(torch, params, cfg)
    for rows in (4, b):
        for mode in ("argmax", "sampled", "mixed"):
            n_tied = 0
            for _ in range(4):
                args = (cfg, *batched_inputs(torch, cfg, gen, rows, k_dyn, mode, True), rope)
                got, got_l = fb.fused_fast_frame_batched(exact, *args, rep_enabled=rep,
                                                         return_logits=True)
                ref, ref_l = fb.fused_fast_frame_batched_plain(exact, *args, rep_enabled=rep,
                                                               return_logits=True)
                check(torch.equal(got_l, ref_l), f"{tag} B={rows} {mode}: exact logits differ")
                n_diff = int((got != ref).sum())
                check(n_diff == 0, f"{tag} B={rows} {mode}: {n_diff} of "
                      f"{rows * n_cb} tokens differ from the plain version")
                if mode == "mixed":
                    check(not bool(got[2].any()), f"{tag}: EOS row not all 0")
                n_tied += sum(vocab - len(torch.unique(r)) for r in ref_l.reshape(-1, vocab))
            log(phase, f"{tag} exact inputs, B={rows}, {mode} rows: "
                f"{4 * rows * n_cb} tokens over 4 frames equal to the plain version (step "
                f"logits bit-equal, {n_tied} tied logit values)")

    # 2. step logits at full weights, argmax rows, up to each row's first
    #    step whose input token differs among kernel, plain, float32
    err_k = err_p = vs_plain = 0.0
    steps = same = 0
    for _ in range(4):
        samp, hidden, window, gumbel, is_eos = batched_inputs(torch, cfg, gen, b, k_dyn,
                                                              "argmax", False)
        args = (samp, hidden, window, gumbel, is_eos, rope)
        tk, lk = fb.fused_fast_frame_batched(params, cfg, *args, rep_enabled=rep,
                                             return_logits=True)
        tp, lp = fb.fused_fast_frame_batched_plain(params, cfg, *args, rep_enabled=rep,
                                                   return_logits=True)
        tr, lr = fb.fused_fast_frame_batched_plain(params32, cfg, samp, hidden.float(), window,
                                                   gumbel, is_eos, rope, rep_enabled=rep,
                                                   return_logits=True)
        same += int((tk == tp).sum())
        for r in range(b):
            differ = ((tk[r] != tp[r]) | (tk[r] != tr[r])).nonzero()
            n = n_cb if len(differ) == 0 else int(differ[0]) + 1
            steps += n
            err_k = max(err_k, float((lk[:n, r] - lr[:n, r]).abs().max()))
            err_p = max(err_p, float((lp[:n, r] - lr[:n, r]).abs().max()))
            vs_plain = max(vs_plain, float((lk[:n, r] - lp[:n, r]).abs().max()))
    check(err_k <= ACCURACY_FACTOR * err_p + 1e-6,
          f"{tag} step logits: {err_k:.4e} from the float32 evaluation, "
          f"plain version {err_p:.4e}")
    log(phase, f"{tag} full weights, B={b} argmax, 4 frames: step "
        f"logits over {steps} row-steps, max abs distance to the float32 evaluation kernel "
        f"{err_k:.4f} | plain {err_p:.4f}, kernel vs plain {vs_plain:.4f}; tokens equal to the "
        f"plain version {same} of {4 * b * n_cb}")

    contract = check_frame_contract(torch, engine, tag, phase)
    n_layer, h, hd = cfg.n_fast_layer, cfg.n_head, cfg.head_dim
    weights = n_layer * layer_elems(cfg) + d + d * vocab
    wbytes, step_bytes = fast_weight_bytes(cfg, int8)
    timed = {}
    for rows in (4, b, 32):
        samp, hidden, window, gumbel, is_eos = batched_inputs(torch, cfg, gen, rows, k_dyn,
                                                              "sampled", False)
        args = (cfg, samp, hidden, window, gumbel, is_eos, rope)
        kernel = lambda: fb.fused_fast_frame_batched(params, *args, rep_enabled=rep)  # noqa: E731
        ms = device_ms(torch, kernel, calls=10, replays=5)
        # read once: the weights (int8 ones with their scales) and head; per
        # row the hidden, the C-1 embedding rows gathered, its windows,
        # draws, knobs and EOS flag; written: the C tokens of each row. The
        # re-read floor streams a step's weights and head at every step.
        per_row = (2 * d + 2 * d * (n_cb - 1) + 4 * n_cb * 12 + 4 * n_cb * k_dyn + 4 * 4 + 1
                   + 4 * n_cb)
        once = wbytes + rows * per_row
        reread = once + n_cb * step_bytes - wbytes
        attn = 4 * h * hd * n_cb * (n_cb + 1) // 2 * n_layer
        flops = rows * (n_cb * 2 * (weights - (2 * n_layer + 1) * d) + attn)
        bound_ms, bound_by = bound(once, flops)
        reread_ms, _ = bound(reread, flops)
        timed[rows] = (ms, bound_ms, bound_by, reread_ms, once, reread)
        line = (f"{tag} B={rows} ({n_cb} steps x {n_layer} layers, one launch): kernel "
                f"{ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}, read once, "
                f"{once / 1e6:.1f} MB), re-read floor {reread_ms:.6f} ms ({reread / 1e6:.1f} MB, "
                f"{100 * reread_ms / ms:.1f}% of the kernel); grid {contract['grid']}, "
                f"{contract['smem']} B of shared memory a block, {contract['ring_stages']} ring "
                f"stages")
        if rows == b:
            call_ms = eager_ms(torch, kernel, 20)
            plain_ms = device_ms(
                torch, lambda: fb.fused_fast_frame_batched_plain(params, *args, rep_enabled=rep),
                calls=2, replays=3)
            line += f"; eager call {call_ms:.4f} ms, plain {plain_ms:.4f} ms"
        log(phase, line)
    ms, bound_ms, bound_by, reread_ms, _, _ = timed[b]
    return {
        "name": name, "route": "cuda",
        "source": "fish_speech_tpu_torch/csrc/fast_frame_batched.cu",
        "replaces": "fish_speech_tpu/ops/fast_frame_pallas.py:" + ("532" if int8 else "1007"),
        "max_abs_err": vs_plain, "err_vs_float32": [err_k, err_p],
        "ms": ms, "kernel_ms": ms, "eager_call_ms": call_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_reread_ms": reread_ms, "library_ms": None,
        "kernel_ms_at_rows": {str(r): t[0] for r, t in timed.items()},
        "share_of_reread_floor": {str(r): t[3] / t[0] for r, t in timed.items()},
        **contract,
        "shape": f"hidden ({b},{d}), {n_cb} codebooks x {n_layer} layers "
                 f"({'int8' if int8 else 'bf16'}), vocab {vocab}, k_dyn {k_dyn}, window 12",
    }


def check_frame_contract(torch, engine, name: str, phase: str = "kernels") -> dict:
    """The batched frame kernel's contract on the card
    (csrc/fast_frame_batched.cu, one persistent launch a frame): its plan
    as built equals ops/decode_stack.py's mirror; one launch a call,
    counted by the wrapper and by the kernel in its sync state, and the
    grid syncs and head 0's exchanges the kernel counts equal to the
    plan's; five calls bit-identical; each of the engine's 16 rows alone
    bit-equal to itself among 16 (tokens and step logits); a CUDA graph's
    replay equal to the eager call; the call completes while a long kernel
    holds an SM on a second stream. Returns the plan's and the counted
    numbers for the kernels line."""
    from fish_speech_tpu_torch.ops import decode_stack as ds
    from fish_speech_tpu_torch.ops import fast_frame_batched as fb
    from fish_speech_tpu_torch.ops.sampling import RowSampling

    cfg, params, rope = engine.cfg, engine.params, engine.rope
    int8 = is_int8(engine)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    b, n_layer, n_cb = engine.batch_size, cfg.n_fast_layer, cfg.num_codebooks
    k_dyn = min(engine.dyn_top_k_cap, cfg.codebook_size)
    mirror = fb.frame_plan(cfg, k_dyn, int8, ds.grid_of(dev))
    card = ds.frame_plan_on_card(n_layer, cfg.dim, cfg.n_head, cfg.n_local_heads,
                                 cfg.intermediate_size, n_cb, cfg.codebook_size, k_dyn, int8)
    check(card == mirror, f"{name}: the plan on the card {card} differs from the mirror {mirror}")
    inputs = batched_inputs(torch, cfg, gen, b, k_dyn, "mixed", False)
    state = ds.new_sync_state(dev)

    def call(rows=slice(None)):
        samp = RowSampling(*(t[rows] for t in inputs[0]))
        return fb.fused_fast_frame_batched(params, cfg, samp, *(t[rows] for t in inputs[1:]),
                                           rope, rep_enabled=not cfg.depthwise_wte, return_logits=True,
                                           sync=state)

    before, on_card = fb.launches, ds.frame_launch_count(dev, state)
    outs = [call() for _ in range(5)]
    torch.cuda.synchronize()
    launched = ds.frame_launch_count(dev, state) - on_card
    syncs, exchanges = ds.last_call_counts(dev, state)
    want = (mirror.syncs_per_call(n_layer, n_cb), mirror.head_exchanges(n_layer, n_cb))
    check(fb.launches - before == 5 and launched == 5,
          f"{name}: 5 calls counted {fb.launches - before} by the wrapper, {launched} launches by "
          "the kernel")
    check((syncs, exchanges) == want, f"{name}: the kernel counted {syncs} grid syncs and "
          f"{exchanges} head exchanges a call, the plan {want}")
    check(all(torch.equal(x, y) for o in outs[1:] for x, y in zip(o, outs[0])),
          f"{name}: five repeated calls are not bit-identical")
    for r in range(b):
        one = call(slice(r, r + 1))
        check(torch.equal(one[0][0], outs[0][0][r]) and torch.equal(one[1][:, 0], outs[0][1][:, r]),
              f"{name}: row {r} alone differs from the same row among {b}")

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = call()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(captured, outs[0])),
              f"{name}: a CUDA graph's replay differs from the eager call")

    other = torch.cuda.Stream()
    with torch.cuda.stream(other):
        torch.cuda._sleep(400_000_000)  # ~0.2 s of one spinning block
    t0 = time.perf_counter()
    got = call()
    torch.cuda.synchronize()
    beside_s = time.perf_counter() - t0
    check(all(torch.equal(x, y) for x, y in zip(got, outs[0])),
          f"{name}: the call beside a second stream's kernel differs")
    rp = mirror.rows
    log(phase, f"{name} persistent kernel: plan on the card equal to the mirror (grid "
        f"{rp.grid} x {ds.BLOCK_THREADS} threads, {rp.smem} B of shared memory a block, ring of "
        f"{rp.stages} stages x {rp.stage_bytes} B, QKV {rp.qkv_tiles}x{rp.qkv_splits} units, "
        f"attention+wo {rp.attn_units}, w1/w3+w2 {rp.sw_units} ({rp.sw_split}-way K-split), head "
        f"{rp.head_tiles}x{rp.head_splits}; the draw's {mirror.draw_bytes} B of shared memory, a "
        f"{mirror.sort_keys}-key sort at k_dyn {k_dyn}); counted on the card: {launched // 5} "
        f"launch a call, {syncs} grid syncs and {exchanges} head exchanges a call; 5 calls "
        f"bit-identical; each of {b} mixed rows alone bit-equal to itself among {b}; CUDA graph "
        f"replay equal to eager; completes beside a kernel on a second stream ({beside_s:.3f} s "
        f"including the wait)")
    return {"grid": rp.grid, "smem": rp.smem, "ring_stages": rp.stages,
            "syncs_per_call": syncs, "kv_exchanges_per_call": exchanges,
            "launches_per_call": launched // 5}


def check_rows_gemms(torch, engine) -> list:
    """Each of the five GEMMs of the launch sequence the batched frame's
    persistent kernel replaced, on its own (fs_rows_gemm; no path of the
    port launches it) at the serving engine's B = 16, on layer 0 of its
    fast stack and its head: the plan the kernel launches with equals rows_plan's; the kernel
    as close to a float32 evaluation (the plain version on float32 copies
    of the inputs, int8 weights dequantized) as the plain version is,
    within ACCURACY_FACTOR (tensor cores and cuBLAS add the products in
    other orders, and a sum that cancels can move a bf16 rounding by more
    than an ulp of the result); a row's bits alike at 1 and 16 rows; then
    kernel, plain and cuBLAS (torch.matmul of the same (16, K) x (K, N)
    bf16 product, the yardstick only) timed beside the byte bound, the
    kernel and cuBLAS both with the weights warm in L2 (back-to-back
    calls) and cold (a 64 MB write before each call, its own time
    subtracted), as the frame finds them."""
    from fish_speech_tpu_torch.ops import fast_frame_batched as fb
    from fish_speech_tpu_torch.ops.quant import is_quantized

    cfg, params = engine.cfg, engine.params
    int8 = is_int8(engine)
    b = engine.batch_size
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(66)
    fast = params["fast"]
    layer0 = lambda k: ({"q": fast[k]["q"][0], "s": fast[k]["s"][0]}  # noqa: E731
                        if is_quantized(fast[k]) else fast[k][0])
    vocab = cfg.codebook_size
    gemms = (("wqkv", "qkv", layer0("wqkv"), None, fast["attention_norm"][0]),
             ("wo", "residual", layer0("wo"), None, None),
             ("w1+w3", "swiglu", layer0("w1"), layer0("w3"), fast["ffn_norm"][0]),
             ("w2", "residual", layer0("w2"), None, None),
             ("head", "head", params["fast_output"][:, :vocab], None, params["fast_norm"]))
    # a 64 MB write evicts the 50 MB L2: in the frame each GEMM finds its
    # weights cold (a fast layer is ~29 MB, four of them stream per step)
    junk = torch.empty(16 * 2**20, dtype=torch.float32, device=dev)

    def flush_l2():
        junk.zero_()

    flush_ms = device_ms(torch, flush_l2, calls=20, replays=5)
    out = []
    for name, mode, w, w_b, norm_w in gemms:
        q8 = is_quantized(w)
        dense = w["q"] if q8 else w
        k, n = dense.shape
        plan = fb.rows_plan(k, n, mode, q8)
        check(fb.rows_plan_on_card(k, n, mode, q8) == plan,
              f"rows_gemm {name}: the kernel's plan differs from rows_plan")
        x = torch.randn((b, k), generator=gen, device=dev).to(torch.bfloat16)
        res = torch.randn((b, n), generator=gen, device=dev).to(torch.bfloat16)
        eps = float(cfg.norm_eps)

        def run(fn, rows=b):
            o = res[:rows].clone() if mode == "residual" else None
            return fn(mode, x[:rows].contiguous(), w, norm_w, w_b, eps, o)

        got, plain, one = run(fb.rows_gemm), run(fb.rows_gemm_plain), run(fb.rows_gemm, 1)
        f32 = lambda t: None if t is None else float32_copy(t)  # noqa: E731
        ref = fb.rows_gemm_plain(mode, x.float(), f32(w), f32(norm_w), f32(w_b), eps,
                                 res.float() if mode == "residual" else None)
        torch.cuda.synchronize()
        check(torch.equal(one, got[:1]), f"rows_gemm {name}: row 0 alone differs from row 0 of {b}")
        err_k, err_p = as_accurate(f"rows_gemm {name}", got, plain, ref)
        vs_plain = float((got.float() - plain.float()).abs().max())
        tol = (f"distance to the float32 evaluation kernel {err_k:.3e} | plain {err_p:.3e}, "
               f"kernel vs plain {vs_plain:.3e}")

        def kernel():
            return run(fb.rows_gemm)

        ms = device_ms(torch, kernel)
        cold_ms = device_ms(torch, lambda: (flush_l2(), kernel()), calls=20, replays=5) - flush_ms
        plain_ms = device_ms(torch, lambda: run(fb.rows_gemm_plain), calls=10, replays=5)
        # the yardstick's weights: bf16 (int8 ones converted beforehand);
        # w1 and w3 side by side, the same products as the SwiGLU mode
        mats = [m["q"] if q8 else m for m in ((w,) if w_b is None else (w, w_b))]
        lib_w = torch.cat([m.to(torch.bfloat16) for m in mats], dim=1).contiguous()
        library_ms = device_ms(torch, lambda: torch.matmul(x, lib_w))
        library_cold_ms = device_ms(torch, lambda: (flush_l2(), torch.matmul(x, lib_w)),
                                    calls=20, replays=5) - flush_ms
        # bytes: the weights (int8 ones with their scales), the input rows,
        # the norm weights, the residual read; the outputs written once
        n_w = 2 if mode == "swiglu" else 1
        w_bytes = n_w * (dense.numel() * dense.element_size() + (2 * n if q8 else 0))
        nbytes = (w_bytes + 2 * b * k + (2 * k if norm_w is not None else 0)
                  + (2 * b * n if mode == "residual" else 0)
                  + (4 if mode == "head" else 2) * b * n)
        bound_ms, bound_by = bound(nbytes, n_w * 2 * b * k * n)
        log("kernels", f"rows_gemm (off the main path) {name} ({mode}, "
            f"{'int8' if q8 else 'bf16'}, B={b}, K={k}, "
            f"N={n}; {plan.blocks} blocks = {plan.blocks // plan.splits} tiles x {plan.splits} "
            f"splits, {plan.stages} stages): kernel {ms:.4f} ms L2-warm, {cold_ms:.4f} ms "
            f"L2-cold; plain {plain_ms:.4f} ms; cuBLAS bf16 matmul {library_ms:.4f} ms warm, "
            f"{library_cold_ms:.4f} ms cold; bound {bound_ms:.6f} ms ({bound_by}, "
            f"{nbytes / 1e6:.2f} MB); "
            f"{tol}; row 0 alone bit-equal")
        out.append({"gemm": name, "mode": mode, "K": k, "N": n, "int8": q8, "blocks": plan.blocks,
                    "splits": plan.splits, "err_vs_float32": [err_k, err_p],
                    "max_abs_err": vs_plain, "ms": ms, "cold_ms": cold_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "library_cold_ms": library_cold_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by})
    return out


# --------------------------------------------------------------------------
# Phase 4: the main path
# --------------------------------------------------------------------------


def build_models(torch):
    """Fish-1.5 engines on random bf16 weights (seed 0), sharing the
    weights: the default `auto` batch-1 engine (fused decode path), the
    unfused one, the two 16-row serving engines (`auto`: the batched
    fast-frame kernel; `xla`: the unfused codebook loop), and the int8
    batch-1 and serving `auto` engines (quantize_int8=True, quantized on
    the card); the Firefly-1.5 codec (seed 1). Returns the engines, the
    codec and the full (un-gathered) parameters for the int8 proxy."""
    from fish_speech_tpu_torch.config import (
        DualARConfig, FireflyConfig, FishVersion, TokenConfig, WhichLM)
    from fish_speech_tpu_torch.generate.engine import LMEngine
    from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec, init_firefly_params
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params
    from fish_speech_tpu_torch.ops.sampling import BATCHED_REP_PEN_WINDOW

    cfg = DualARConfig.fish_speech_1_5()
    tok = TokenConfig(im_end_id=100011, pad_id=5, semantic_start_id=100012,
                      semantic_end_id=100012 + cfg.codebook_size - 1)
    codec_cfg = FireflyConfig.for_version(FishVersion.V1_5)
    t0 = time.perf_counter()
    params = init_dual_ar_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    # random weights must not stop early: zero the im_end head column
    params["output"][:, tok.im_end_id] = 0
    codec_params = init_firefly_params(codec_cfg, seed=1, dtype=torch.bfloat16, device="cuda")
    fused = LMEngine(params, cfg, tok, WhichLM.FISH_1_5, max_frames=N_FRAMES,
                     prompt_buckets=(64,))
    unfused = LMEngine(params, cfg, tok, WhichLM.FISH_1_5, max_frames=N_FRAMES_UNFUSED,
                       prompt_buckets=(64,), slow_impl="xla", fast_frame_impl="xla")
    serve_kw = dict(batch_size=SERVE_ROWS, cache_len=SERVE_CACHE, max_frames=N_FRAMES,
                    prompt_buckets=(64,), rep_pen_window=BATCHED_REP_PEN_WINDOW,
                    dynamic_sampling=True)
    serving = {impl: LMEngine(params, cfg, tok, WhichLM.FISH_1_5, fast_frame_impl=impl,
                              **serve_kw)
               for impl in ("auto", "xla")}
    # the unfused slow step beside the batched fast frame: the serving
    # path before the row kernel, against which the A/B sets `auto`
    serving["slow_xla"] = LMEngine(params, cfg, tok, WhichLM.FISH_1_5, slow_impl="xla",
                                   **serve_kw)
    t1 = time.perf_counter()
    int8 = {"batch1": LMEngine(params, cfg, tok, WhichLM.FISH_1_5, max_frames=N_FRAMES,
                               prompt_buckets=(64,), quantize_int8=True),
            "serving": LMEngine(params, cfg, tok, WhichLM.FISH_1_5, quantize_int8=True,
                                **serve_kw)}
    torch.cuda.synchronize()
    quant_s = (time.perf_counter() - t1) / 2
    check(fused.use_fused_slow and fused.use_fused_fast,
          "the default engine on CUDA at batch 1 is not on the fused path")
    check(not (unfused.use_fused_slow or unfused.use_fused_fast), "the xla engine is fused")
    check(serving["auto"].use_fused_fast and serving["auto"].use_fused_slow,
          "the serving engine's auto path is not the batched fast frame + the slow step's "
          "row kernel")
    check(serving["slow_xla"].use_fused_fast and not serving["slow_xla"].use_fused_slow,
          "the slow_xla serving engine is not the batched fast frame + unfused slow step")
    check(not serving["xla"].use_fused_fast, "the xla serving engine's codebook loop is fused")
    check(int8["batch1"].use_fused_slow and int8["batch1"].use_fused_fast,
          "the int8 engine on CUDA at batch 1 is not on the fused path")
    check(int8["serving"].use_fused_fast and int8["serving"].use_fused_slow,
          "the int8 serving engine's auto path is not the batched fast frame + row kernel")
    codec = FireflyCodec(codec_params, codec_cfg)
    torch.cuda.synchronize()
    log("main", f"Fish-1.5 bf16 params (seed 0) + Firefly-1.5 bf16 codec (seed 1) on the card "
        f"in {time.perf_counter() - t0:.1f}s; cache_len {fused.cache_len}; engines: auto "
        f"(fused slow step + fused fast frame), xla (unfused), and {SERVE_ROWS}-row serving "
        f"engines (cache {SERVE_CACHE}) auto (the slow step's row kernel + batched fast "
        f"frame), slow_xla (unfused slow step + batched fast frame) and xla (unfused codebook "
        f"loop); int8 batch-1 and serving auto engines, {quant_s:.2f}s each to quantize on the "
        f"card")
    check_card_quantization(torch, params, int8["batch1"])
    return fused, unfused, serving, int8, codec, tok, codec_cfg, params


def check_card_quantization(torch, params, engine) -> None:
    """The int8 engine's stacks, quantized on the card, are bit-equal to
    the CPU quantization of the same bf16 weights."""
    from fish_speech_tpu_torch.ops.quant import QUANT_KEYS, quantize_weight

    n = 0
    for stack in ("slow", "fast"):
        for k in QUANT_KEYS:
            ref = quantize_weight(params[stack][k].cpu())
            got = engine.params[stack][k]
            check(torch.equal(got["q"].cpu(), ref["q"]) and torch.equal(got["s"].cpu(), ref["s"]),
                  f"int8 {stack}.{k}: the card's quantization differs from the CPU's")
            n += ref["q"].numel()
    log("main", f"int8 quantization on the card: q and s of the {2 * len(QUANT_KEYS)} slow and "
        f"fast matmul stacks ({n} weights) bit-equal to the CPU quantization")


def main_prompt(np, cfg):
    """The 40-token prompt of the batch-1 runs (text frames)."""
    rng = np.random.default_rng(0)
    return np.concatenate([
        rng.integers(1000, min(90000, cfg.vocab_size), size=(1, PROMPT_LEN)),
        np.zeros((cfg.num_codebooks, PROMPT_LEN), np.int64),
    ]).astype(np.int32)


def decode_frames(engine, budget: int) -> int:
    """The frames the card runs for a `generate` of `budget` decode frames
    that does not end early: its chunks' whole horizons under the captured
    loop (a budget-cut chunk's masked frames run too), the frames that
    count rounded up to the unroll eagerly (`LMEngine._decode`)."""
    plan, u = engine.chunk_plan(budget), engine.decode_unroll
    if engine.graphs is not None:
        return sum(h for h, _ in plan)
    return sum(-(-n // u) * u for _, n in plan)


def run_path(torch, np, engine, codec, tok, codec_cfg, n_frames: int, label: str):
    """Generate n_frames from the 40-token prompt, vocode, check codes,
    PCM and WAV; returns the launch counts of the run (all, and those of
    the int8 bodies), its state and its sampling."""
    from fish_speech_tpu_torch.audio.wav import pcm_to_wav_bytes
    from fish_speech_tpu_torch.generate.overlap import output_shift
    from fish_speech_tpu_torch.ops import decode_attention as da
    from fish_speech_tpu_torch.ops import fast_frame as ff
    from fish_speech_tpu_torch.ops import prefill_attention as pa
    from fish_speech_tpu_torch.ops import slow_step as ss
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    cfg = engine.cfg
    shift = output_shift(engine.lm)  # Fish <= 1.4 emits codebook tokens + 1
    prompt = main_prompt(np, cfg)
    sampling = SamplingArgs(**SAMPLING)

    t0 = time.perf_counter()
    # the warm-up's frames are the counted run's: its decode loops are
    # captured here, outside the count
    engine.generate(prompt, max_new_tokens=n_frames, sampling=sampling, seed=0)
    codec.decode(np.zeros((cfg.num_codebooks, n_frames), np.int32))  # the same shape
    torch.cuda.synchronize()
    log("main", f"{label}: warm-up generation ({n_frames} frames) and vocode ({n_frames} "
        f"frames) {time.perf_counter() - t0:.2f}s")

    mods = {"decode_attention": da, "prefill_attention": pa, "fused_slow_step": ss,
            "fused_fast_frame": ff}
    for m in mods.values():
        m.launches = 0
        m.int8_launches = 0
    t0 = time.perf_counter()
    res, state = engine.generate(prompt, max_new_tokens=n_frames, sampling=sampling, seed=1)
    lm_s = time.perf_counter() - t0
    launches = {name: m.launches for name, m in mods.items()}
    int8 = {name: getattr(m, "int8_launches", 0) for name, m in mods.items()}
    t1 = time.perf_counter()
    pcm = codec.decode(shift(res.tokens))
    torch.cuda.synchronize()
    voc_s = time.perf_counter() - t1
    wav = pcm_to_wav_bytes(pcm[0], codec.sample_rate)

    codes = np.concatenate([res.semantic[None], shift(res.tokens)])
    check(codes.shape == (cfg.num_codebooks + 1, n_frames), f"{label}: codes shape {codes.shape}")
    if tok.semantic_end_id is None:  # Fish <= 1.4: PAD, drawn against <|im_end|>
        sem_ok = codes[0] == tok.pad_id
    else:
        sem_ok = (codes[0] >= tok.semantic_start_id) & (codes[0] <= tok.semantic_end_id)
    check(bool(sem_ok.all()), f"{label}: semantic ids outside the semantic range")
    check(bool(((codes[1:] >= 0) & (codes[1:] < cfg.codebook_size)).all()),
          f"{label}: codebook ids outside [0, codebook_size)")
    n_samples = n_frames * codec.samples_per_frame
    check(pcm.shape == (1, n_samples), f"{label}: pcm shape {pcm.shape}, expected (1, {n_samples})")
    check(bool(np.isfinite(pcm).all()), f"{label}: non-finite PCM")
    with wave.open(io.BytesIO(wav)) as w:
        check((w.getnchannels(), w.getsampwidth(), w.getframerate(), w.getnframes())
              == (1, 2, codec.sample_rate, n_samples), f"{label}: WAV header")
    audio_s = n_frames / codec_cfg.frame_rate
    log("main", f"{label}: codes {codes.shape} in range; pcm {pcm.shape} finite, "
        f"|pcm|max={float(np.abs(pcm).max()):.3e}; WAV {len(wav)} bytes parses; "
        f"launches {json.dumps(launches)}, of them int8 bodies "
        f"{json.dumps({k: v for k, v in int8.items() if k in ('fused_slow_step', 'fused_fast_frame')})}")
    log("main", f"{label}: lm {lm_s:.3f}s (prefill {res.prefill_s:.3f}s, decode "
        f"{res.decode_s:.3f}s) = {n_frames / lm_s:.1f} frames/s "
        f"({(n_frames - 1) / res.decode_s:.1f} decode frames/s); vocode {voc_s:.3f}s; "
        f"audio {audio_s:.3f}s; RTF {(lm_s + voc_s) / audio_s:.4f}")
    return launches, int8, state, sampling, (n_frames / lm_s, (lm_s + voc_s) / audio_s)


def run_main_path(torch, np, fused, unfused, codec, tok, codec_cfg):
    """Both decode paths, each with its launch counts read around its own
    run; returns {kernel: launches on the path that runs it} and the
    `auto` run's (frames/s, RTF)."""
    n_layer = fused.cfg.n_layer
    steps = decode_frames(fused, N_FRAMES - 1)
    lf, l8, state, sampling, stats = run_path(torch, np, fused, codec, tok, codec_cfg,
                                              N_FRAMES, "auto (fused)")
    want = {"fused_slow_step": steps, "fused_fast_frame": steps,
            "prefill_attention": n_layer, "decode_attention": 0}
    check(lf == want and not any(l8.values()), f"auto path launches {lf} (int8 {l8}), "
          f"expected {want}")
    profile_decode(torch, fused, state, sampling, "auto (fused)",
                   kernel_names=FUSED_DECODE_KERNELS)

    steps_u = decode_frames(unfused, N_FRAMES_UNFUSED - 1)
    lu, _, state_u, _, _ = run_path(torch, np, unfused, codec, tok, codec_cfg,
                                    N_FRAMES_UNFUSED, "xla (unfused)")
    want = {"fused_slow_step": 0, "fused_fast_frame": 0,
            "prefill_attention": n_layer, "decode_attention": n_layer * steps_u}
    check(lu == want, f"xla path launches {lu}, expected {want}")
    compare_decode_step(torch, unfused, state_u)
    # 2 frames: a frame's ~3900 launches make a 17 MB trace file
    profile_decode(torch, unfused, state_u, sampling, "xla (unfused)", frames=2)
    return {"fused_slow_step": lf["fused_slow_step"], "fused_fast_frame": lf["fused_fast_frame"],
            "prefill_attention": lf["prefill_attention"],
            "decode_attention": lu["decode_attention"]}, stats


def run_int8_main_path(torch, np, engine, fused, bf16_first, codec, tok, codec_cfg):
    """The int8 engine's `auto` path, 128 frames: the int8 bodies of the
    fused slow step and fast frame; returns their launch counts. With
    one more int8 run and one more bf16 run, the A/B against the bf16
    `auto` engine is in turns: bf16 (bf16_first, the main path's run),
    int8, int8, bf16."""
    n_layer = engine.cfg.n_layer
    steps = decode_frames(engine, N_FRAMES - 1)
    lf, l8, state, sampling, first = run_path(torch, np, engine, codec, tok, codec_cfg,
                                              N_FRAMES, "int8 auto (fused)")
    want = {"fused_slow_step": steps, "fused_fast_frame": steps,
            "prefill_attention": n_layer, "decode_attention": 0}
    check(lf == want and l8["fused_slow_step"] == steps and l8["fused_fast_frame"] == steps,
          f"int8 auto path launches {lf} (int8 bodies {l8}), expected {want}, all int8")
    again = run_path(torch, np, engine, codec, tok, codec_cfg, N_FRAMES, "int8 auto run 2")[4]
    bf16 = run_path(torch, np, fused, codec, tok, codec_cfg, N_FRAMES, "auto (fused) run 2")[4]
    log("main", f"batch-1 A/B in turns (bf16, int8, int8, bf16), means of two runs: int8 "
        f"{(first[0] + again[0]) / 2:.1f} frames/s, RTF {(first[1] + again[1]) / 2:.4f}; bf16 "
        f"{(bf16_first[0] + bf16[0]) / 2:.1f} frames/s, RTF {(bf16_first[1] + bf16[1]) / 2:.4f}")
    profile_decode(torch, engine, state, sampling, "int8 auto (fused)",
                   kernel_names=FUSED_DECODE_KERNELS)
    return {"fused_slow_step_int8": l8["fused_slow_step"],
            "fused_fast_frame_int8": l8["fused_fast_frame"]}


LONG_PROMPT = 2000  # a voice-cloning prompt: reference-audio frames and text


def run_long_prefill(torch, np, params, cfg, tok) -> dict:
    """LMEngine.prefill of a 2000-token prompt (bucket 2048, cache 4096,
    batch 1, bf16, default buckets): median seconds of 5 after a warm-up,
    the prefill kernel's launches, and under torch.profiler over one
    prefill the device time, the attention kernel's share of it and the
    top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from fish_speech_tpu_torch.config import WhichLM
    from fish_speech_tpu_torch.generate.engine import LMEngine
    from fish_speech_tpu_torch.ops import prefill_attention as pa
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    engine = LMEngine(params, cfg, tok, WhichLM.FISH_1_5, max_frames=8)
    rng = np.random.default_rng(2)
    prompt = np.concatenate([rng.integers(1000, 90000, size=(1, LONG_PROMPT)),
                             np.zeros((cfg.num_codebooks, LONG_PROMPT), np.int64)]).astype(np.int32)
    sampling = SamplingArgs(**SAMPLING)
    state = engine.init_state(0)
    engine.prefill(state, prompt, sampling)  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        pa.launches = 0
        t0 = time.perf_counter()
        _, frame, _ = engine.prefill(state, prompt, sampling)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(pa.launches == cfg.n_layer, f"long prefill: {pa.launches} prefill_attention "
              f"launches, expected {cfg.n_layer}")
    check(bool(((frame[0, 1:] >= 0) & (frame[0, 1:] < cfg.codebook_size)).all()),
          "long prefill: first frame's codes out of range")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        engine.prefill(state, prompt, sampling)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    attn_ms = sum(e.self_device_time_total for e in kernels if "prefill_" in e.key
                  and ("attention_kernel" in e.key or "combine_kernel" in e.key)) / 1e3
    median = float(np.median(times))
    if dev_ms > 0:
        share = f"{100 * attn_ms / dev_ms:.1f}% of it"
    else:
        share = "share not measured (the profiler saw no device time)"
    log("prefill", f"LMEngine.prefill, {LONG_PROMPT}-token prompt (bucket 2048, cache "
        f"{engine.cache_len}, batch 1, bf16): median {median:.4f}s of 5 "
        f"({', '.join(f'{t:.4f}' for t in times)}), {cfg.n_layer} prefill_attention launches "
        f"each; under torch.profiler: device kernels {dev_ms:.3f} ms in "
        f"{sum(e.count for e in kernels)} launches, prefill attention {attn_ms:.3f} ms, {share}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log("prefill", f"  {e.self_device_time_total / 1e3:8.4f} ms {e.count:5d}x  {e.key[:90]}")
    del engine, state
    return {"prompt_tokens": LONG_PROMPT, "median_s": median, "runs_s": times,
            "device_ms": dev_ms, "attention_ms": attn_ms,
            "attention_share": attn_ms / dev_ms if dev_ms > 0 else None}


# the fused kernels of the batch-1 `auto` path, as the trace names them
FUSED_DECODE_KERNELS = ("decode_stack_kernel", "ds_sampler_kernel")


def profile_decode(torch, engine, state, sampling, label: str, frames: int = 8,
                   kernel_names=()) -> None:
    """Where a decode frame's time goes: a device_trace (utils/profiling)
    of a few frames under annotate("decode"), whose trace file must parse
    and hold the region and a kernel of each of kernel_names; device time
    summed over CUDA kernels, against the wall."""
    import tempfile

    from fish_speech_tpu_torch.utils.profiling import annotate, device_trace

    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp) as trace:
            t0 = time.perf_counter()
            with annotate("decode"):
                for _ in range(frames):
                    state, _ = engine.decode_step(state, sampling)
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / frames
        size = trace.path.stat().st_size
        with open(trace.path) as f:
            events = json.load(f)["traceEvents"]
    in_file = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    check(any(e.get("name") == "decode" for e in events),
          f"profile {label}: the trace file holds no 'decode' region")
    for name in kernel_names:
        check(any(name in k for k in in_file), f"profile {label}: no {name} in the trace file")
    log("profile", f"{label}: device_trace file {size} bytes, {len(events)} events, the "
        f"'decode' region and {len(in_file)} kernel names"
        + (f", {' and '.join(kernel_names)} among them" if kernel_names else ""))
    kernels = device_kernels(trace.prof, regions=("decode",))
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / frames
    launches = sum(e.count for e in kernels) / frames
    log("profile", f"{label}: decode frame under torch.profiler: wall {wall_ms:.2f} ms, device "
        f"kernels {dev_ms:.3f} ms ({launches:.0f} launches), device busy "
        f"{100 * dev_ms / wall_ms:.1f}%")
    log_top_kernels("profile", kernels, frames, "frame")


def compare_decode_step(torch, engine, state) -> None:
    """One full-width unfused decode step through the kernels and through
    the plain versions, from the same state."""
    from unittest import mock

    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.models.dual_ar import KVCache, slow_decode_step
    from fish_speech_tpu_torch.ops.decode_attention import decode_attention_plain

    def step():
        cache = KVCache(k=state.cache.k.clone(), v=state.cache.v.clone())
        with torch.inference_mode():
            logits, _ = slow_decode_step(engine.params, engine.cfg, engine.token_cfg,
                                         state.prev, cache, state.pos, engine.rope)
        return logits

    got = step()
    with mock.patch.object(dual_ar, "decode_attention", decode_attention_plain):
        ref = step()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(err <= STEP_LOGITS_ATOL, f"decode step logits max abs err {err}")
    check(int(got.argmax()) == int(ref.argmax()), "decode step argmax differs")
    log("main", f"full-width unfused decode step at pos {int(state.pos[0])}, kernels vs plain: "
        f"logits max_abs_err={err:.3e} (atol={STEP_LOGITS_ATOL}), argmax equal")


# --------------------------------------------------------------------------
# Phase 4b: streaming vocode, the overlapped batch-1 driver, TTFA
# --------------------------------------------------------------------------

STREAM_FRAMES = 128
STREAM_CHUNKINGS = {
    "[128]": [128],
    "[5,16,16,...]": [5] + [16] * 7 + [11],
    "[1]*32+[96]": [1] * 32 + [96],
    "powers of two": [64, 32, 16, 8, 4, 2, 1, 1],
}
# A float32 stream against the float32 batch decode (TF32 off for the
# whole run): the same ops on other lengths, where cuDNN may pick other
# algorithms, so not bit-equal.
STREAM_F32_ATOL = 1e-4
STREAM_F32_RTOL = 1e-3  # of the largest |PCM|
# Central-vocoder PCM crosses to the host as int16: 0.5 / 32767 of
# rounding, held at 5e-5 on top of the bf16 bound.
PCM_I16_ATOL = 5e-5
# The random codec's PCM peaks near 6e-7, below int16's step (1/32767),
# where the central vocoder would deliver zeros and any PCM check would
# hold. So the phases from here on run a copy of the codec whose conv_post
# weight is scaled by a power of two (exact in bf16) to bring the stream
# phase's PCM peak near STREAM_PEAK (tanh keeps it below 1), and every
# PCM check also requires its reference to peak at PCM_MIN_STEPS int16
# steps or more.
STREAM_PEAK = 0.3
PCM_MIN_STEPS = 100
OVERLAP_CHUNK = 64  # bench.py's RTF mode
OVERLAP_TRIALS = 5
TTFA_TRIALS = 11
TTFA_FRAMES = 16  # bench.py::bench_ttfa's one decode chunk


def stream_decode(np, codec, codes, chunking):
    """codes (C, T) fed to a fresh session in the given pieces -> (T * spf,)."""
    sess = codec.start_stream(max_step_frames=max(chunking))
    parts, s = [], 0
    for n in chunking:
        parts.append(sess.feed(codes[:, s:s + n])[0])
        s += n
    return np.concatenate(parts)


def loud_codec(np, codec, codec_cfg, codes):
    """A copy of the bf16 codec whose conv_post weight is scaled by a
    power of two (exact in bf16) so that its decode of `codes` peaks near
    STREAM_PEAK. Returns (codec, scale)."""
    from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec

    peak = float(np.abs(codec.decode(codes)).max())
    check(np.isfinite(peak) and peak > 0, f"stream: the codec's PCM peak is {peak}")
    scale = 2.0 ** round(float(np.log2(STREAM_PEAK / peak)))
    head = codec.params["head"]
    post = {**head["conv_post"], "w": head["conv_post"]["w"] * scale}
    return FireflyCodec({**codec.params, "head": {**head, "conv_post": post}}, codec_cfg,
                        device=codec.device), scale


def run_stream(torch, np, codec, codec_cfg, smi):
    """The full-width Firefly-1.5 codec (seed 1, made loud by
    `loud_codec`) on 128 frames of seeded codes, fed in four chunkings: a
    float32 copy of the weights streams what its batch decode gives
    (STREAM_F32_ATOL, and STREAM_F32_RTOL of the largest |PCM|), and the
    bf16 codec's stream is as close to the float32 batch decode as the
    bf16 batch decode is, within ACCURACY_FACTOR. Times decode_step (host
    codes in, host PCM out) at 16 and 64 frames, batch 1 and 16. Returns
    the loud bf16 codec and its float32 copy for the later phases, and the
    bf16 bound (ACCURACY_FACTOR x the bf16 batch decode's largest distance
    to the float32 one)."""
    from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec

    t0 = time.perf_counter()
    n_codes = codec_cfg.quantizer.n_groups * codec_cfg.quantizer.n_codebooks
    codes = np.random.default_rng(1).integers(0, 1000, size=(n_codes, STREAM_FRAMES))
    codes = codes.astype(np.int32)
    codec, scale = loud_codec(np, codec, codec_cfg, codes)
    codec32 = FireflyCodec(float32_copy(codec.params), codec_cfg)
    ref32, ref16 = codec32.decode(codes)[0], codec.decode(codes)[0]
    peak = float(np.abs(ref32).max())
    batch_err = float(np.abs(ref16 - ref32).max())
    check(np.isfinite(ref16).all() and peak * 32767 >= PCM_MIN_STEPS and batch_err > 0,
          f"stream: batch decodes not finite, below {PCM_MIN_STEPS} int16 steps or equal "
          f"(peak {peak}, bf16 {batch_err})")
    log("stream", f"conv_post weight x {scale:g} (a power of two): |pcm|max {peak:.4f} = "
        f"{peak * 32767:.0f} int16 steps")
    for name, chunking in STREAM_CHUNKINGS.items():
        err32 = float(np.abs(stream_decode(np, codec32, codes, chunking) - ref32).max())
        got16 = stream_decode(np, codec, codes, chunking)
        err16 = float(np.abs(got16 - ref32).max())
        check(err32 <= STREAM_F32_ATOL and err32 <= STREAM_F32_RTOL * peak,
              f"stream {name}: float32 stream {err32:.3e} from the float32 batch decode "
              f"(atol {STREAM_F32_ATOL}, rtol {STREAM_F32_RTOL} of |pcm|max {peak:.3e})")
        check(np.isfinite(got16).all() and err16 <= ACCURACY_FACTOR * batch_err,
              f"stream {name}: bf16 stream {err16:.3e} from the float32 batch decode, the bf16 "
              f"batch decode {batch_err:.3e} (factor {ACCURACY_FACTOR})")
        log("stream", f"Firefly-1.5, {STREAM_FRAMES} frames fed as {name} ({len(chunking)} "
            f"feeds): float32 stream vs float32 batch max_abs_err {err32:.3e} "
            f"({err32 / peak:.2e} of |pcm|max {peak:.3e}; TF32 off); bf16 stream vs float32 "
            f"batch {err16:.3e}, bf16 batch vs float32 batch {batch_err:.3e} "
            f"(ratio {err16 / batch_err:.3f}, limit {ACCURACY_FACTOR})")
    for b in (1, 16):
        state = codec.stream_template(b)
        for t in (16, 64):
            c = np.tile(codes[None, :, :t], (b, 1, 1))
            ms = eager_ms(torch, lambda: codec.decode_step(c, state), 10)
            audio_ms = 1e3 * b * t / codec_cfg.frame_rate
            log("stream", f"decode_step bf16 (host codes in, host PCM out), batch {b} x {t} "
                f"frames: {ms:.3f} ms ({audio_ms / ms:.1f}x real time for {audio_ms:.0f} ms "
                f"of audio) on {smi}")
    log("stream", f"phase {time.perf_counter() - t0:.1f}s; the bf16 bound of the later "
        f"phases: {ACCURACY_FACTOR * batch_err:.3e}")
    return codec, codec32, ACCURACY_FACTOR * batch_err


def pcm_accuracy(np, codec, codec32, codes, pcm, what: str):
    """pcm (T * spf,) of codes (C, T) against the bf16 codec's and its
    float32 copy's batch decodes: checks the shape, finiteness and that
    the float32 decode peaks at PCM_MIN_STEPS int16 steps or more. Returns
    (distance to the bf16 decode, distance to the float32 decode, the bf16
    decode's own distance to the float32 one, the peak)."""
    ref16, ref32 = codec.decode(codes)[0], codec32.decode(codes)[0]
    check(pcm.shape == ref16.shape and bool(np.isfinite(pcm).all()),
          f"{what}: pcm {pcm.shape}, expected {ref16.shape}, finite")
    peak = float(np.abs(ref32).max())
    check(peak * 32767 >= PCM_MIN_STEPS, f"{what}: the reference PCM peaks at "
          f"{peak * 32767:.1f} int16 steps, fewer than {PCM_MIN_STEPS}")
    return (float(np.abs(pcm - ref16).max()), float(np.abs(pcm - ref32).max()),
            float(np.abs(ref16 - ref32).max()), peak)


def waits_at(torch, fn) -> list:
    """The file:line of every call of fn that waits for the card, as
    PyTorch's sync debug mode ("warn") reports them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in seen
            if "called a synchronizing CUDA operation" in str(w.message)]


def check_no_wait(torch, np, engine, codec, sampling, prompt) -> None:
    """What the overlapped driver and the central vocoder launch between
    two reads queues behind the card's work without waiting for it: a
    64-frame decode chunk, a 64-frame feed of host codes, and a 16-lane
    central-vocoder tick (a lane reset, lanes that sit the tick out, the
    int16 conversion, the copy to the host) make no call that PyTorch's
    sync debug mode reports, and it does report a copy from pageable
    memory."""
    import types

    from fish_speech_tpu_torch.generate.continuous import (
        BatchedRequest, _CentralVocoder, _PartialPCM, _RowState)

    n_codes = codec.cfg.quantizer.n_groups * codec.cfg.quantizer.n_codebooks
    codes = np.random.default_rng(2).integers(0, 1000, size=(n_codes + 1, OVERLAP_CHUNK))
    codes = codes.astype(np.int32)  # (C+1, t): a semantic row, then the codes
    fake = types.SimpleNamespace(horizon=SERVE_HORIZON, engine=types.SimpleNamespace(
        batch_size=SERVE_ROWS, cfg=types.SimpleNamespace(num_codebooks=n_codes)))
    vocoder = _CentralVocoder(fake, codec, None)
    slots = [_RowState(BatchedRequest([None], 0, N_FRAMES, deliver_pcm=True), r)
             for r in range(SERVE_ROWS)]
    held = []
    try:
        state, _, _ = engine.prefill(engine.init_state(0), prompt, sampling)
        session = codec.start_stream(max_step_frames=OVERLAP_CHUNK)
        for slot in slots:  # the first tick, outside the check: warm
            vocoder.enable_row(slot)
            vocoder.push(slot, codes[:, :SERVE_HORIZON])
        vocoder.tick()
        engine.decode_chunk(state, sampling, OVERLAP_CHUNK)
        session.feed_async(codes[1:], pad_to=OVERLAP_CHUNK)
        vocoder.enable_row(slots[0])  # reset lane 0 at the next tick
        for slot in slots[:1] + slots[3:]:  # lanes 1 and 2 sit it out
            vocoder.push(slot, codes[:, SERVE_HORIZON:2 * SERVE_HORIZON])
        # the delivery thread's own waits are its job: hold the tick's
        # copy until the check is over
        vocoder._put = lambda fetch, meta: held.append((fetch, meta))
        sees = waits_at(torch, lambda: torch.from_numpy(codes).to("cuda"))
        found = waits_at(torch, lambda: (
            engine.decode_chunk(state, sampling, OVERLAP_CHUNK),
            session.feed_async(codes[1:], pad_to=OVERLAP_CHUNK), vocoder.tick()))
        del vocoder._put
        check(bool(sees), "no-wait: the sync debug mode does not report a pageable copy")
        check(not found, f"no-wait: launches between two reads wait for the card at {found}")
        for fetch, meta in held:
            vocoder._put(fetch, meta)
        vocoder.drain(timeout=WAIT_S)
    finally:
        vocoder.shutdown()
    got = []
    for slot in slots:
        events = []
        while not slot.req.results.empty():
            events.append(slot.req.results.get_nowait())
        got.append([ev.frames for ev in events if isinstance(ev, _PartialPCM)])
    want = [[SERVE_HORIZON, SERVE_HORIZON]] + [[SERVE_HORIZON]] * 2 + \
        [[SERVE_HORIZON, SERVE_HORIZON]] * (SERVE_ROWS - 3)
    check(got == want, f"no-wait: the central vocoder's PCM events (frames) {got}")
    log("overlap", f"no wait: a {OVERLAP_CHUNK}-frame decode_chunk, a {OVERLAP_CHUNK}-frame "
        f"feed_async of host codes and a {SERVE_ROWS}-lane central-vocoder tick (a reset lane, "
        f"two lanes sitting out) make no call that torch.cuda.set_sync_debug_mode reports (it "
        f"reports a pageable copy at {sees[0]}); the tick's PCM events arrive")


def run_overlap(torch, np, engine, codec, codec32, codec_cfg, bound16, smi) -> None:
    """The batch-1 `auto` engine on the 40-token prompt, 128 frames,
    chunk 64, SAMPLING: generate_vocode_overlapped against generate +
    decode on the same seed (tokens equal; PCM within the bf16 bound of
    codec.decode of the tokens, and as close to the float32 decode as
    codec.decode is, within ACCURACY_FACTOR), its kernels' launches
    counted around the run; that its launches between two reads do not
    wait (`check_no_wait`); then RTF of one warm-up and OVERLAP_TRIALS
    timed trials of each of three drivers, in turns: overlapped, chunked
    (decode_chunk, each chunk read before the next is launched, then one
    batch decode: the overlapped driver without the overlap) and serial
    (generate, then one batch decode); and the host time of one feed."""
    from fish_speech_tpu_torch.generate.overlap import generate_vocode_overlapped, output_shift
    from fish_speech_tpu_torch.ops import fast_frame as ff
    from fish_speech_tpu_torch.ops import prefill_attention as pa
    from fish_speech_tpu_torch.ops import slow_step as ss
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    prompt = main_prompt(np, engine.cfg)
    sampling = SamplingArgs(**SAMPLING)
    shift = output_shift(engine.lm)
    kw = dict(sampling=sampling, max_new_tokens=N_FRAMES, chunk=OVERLAP_CHUNK, shift_fn=shift)
    generate_vocode_overlapped(engine, codec, prompt, seed=4, **kw)  # warm-up
    mods = {"prefill_attention": pa, "fused_slow_step": ss, "fused_fast_frame": ff}
    for m in mods.values():
        m.launches = 0
    pcm, res, _ = generate_vocode_overlapped(engine, codec, prompt, seed=5, **kw)
    torch.cuda.synchronize()
    launches = {name: m.launches for name, m in mods.items()}
    check(all(launches.values()), f"overlap: launches {launches}, expected all non-zero")
    ref, _ = engine.generate(prompt, max_new_tokens=N_FRAMES, sampling=sampling, seed=5)
    check(np.array_equal(res.tokens, ref.tokens) and np.array_equal(res.semantic, ref.semantic),
          "overlap: tokens differ from generate's on the same seed")
    err16, err32, own, peak = pcm_accuracy(np, codec, codec32, shift(ref.tokens), pcm, "overlap")
    check(err16 <= bound16, f"overlap: PCM {err16:.3e} from codec.decode of the tokens, bound "
          f"{bound16:.3e}")
    check(err32 <= ACCURACY_FACTOR * own, f"overlap: PCM {err32:.3e} from the float32 decode, "
          f"codec.decode {own:.3e} (factor {ACCURACY_FACTOR})")
    log("overlap", f"auto engine, {PROMPT_LEN}-token prompt, {res.frames} frames, chunk "
        f"{OVERLAP_CHUNK}: tokens equal generate's (seed 5); PCM (|pcm|max {peak:.4f}) "
        f"max_abs_err {err16:.3e} from codec.decode (bf16 bound {bound16:.3e}), {err32:.3e} "
        f"from the float32 decode (codec.decode {own:.3e}, ratio {err32 / own:.3f}); launches "
        f"{json.dumps(launches)}")
    check_no_wait(torch, np, engine, codec, sampling, prompt)

    budget = max(min(N_FRAMES - 1, engine.max_frames, engine.cache_len - PROMPT_LEN - 1), 0)

    def overlapped(seed):
        t0 = time.perf_counter()
        _, r, _ = generate_vocode_overlapped(engine, codec, prompt, seed=seed, **kw)
        wall = time.perf_counter() - t0
        return wall, r.prefill_s + r.decode_s, r.tokens

    def chunked(seed):
        t0 = time.perf_counter()
        state, first, eos, _ = engine._prefill_raw(engine.init_state(seed), prompt, sampling)
        frames, done, produced = [first.cpu().numpy()[0]], bool(eos.cpu()[0]), 0
        while not done and produced < budget:
            n = min(OVERLAP_CHUNK, budget - produced)
            state, out, valid, steps = engine.decode_chunk(state, sampling, OVERLAP_CHUNK,
                                                           max_steps=n)
            out, valid, steps, d = (t.cpu().numpy() for t in (out, valid, steps, state.done))
            produced += n
            for i in range(int(steps)):
                if not valid[i, 0]:
                    done = True
                    break
                frames.append(out[i, 0])
            else:
                done = bool(d[0])
        tokens = np.stack(frames, axis=1)[1:]
        lm = time.perf_counter() - t0
        codec.decode(shift(tokens))
        return time.perf_counter() - t0, lm, tokens

    def serial(seed):
        t0 = time.perf_counter()
        r, _ = engine.generate(prompt, max_new_tokens=N_FRAMES, sampling=sampling, seed=seed)
        lm = time.perf_counter() - t0
        codec.decode(shift(r.tokens))
        wall = time.perf_counter() - t0
        return wall, lm, r.tokens

    drivers = (("overlapped", overlapped), ("chunked", chunked), ("serial", serial))
    runs = {name: [] for name, _ in drivers}
    for trial in range(OVERLAP_TRIALS + 1):  # the first is the warm-up
        for name, fn in drivers:
            runs[name].append(fn(100 + trial))
    for trial in range(OVERLAP_TRIALS + 1):
        check(all(np.array_equal(runs[name][trial][2], runs["serial"][trial][2])
                  for name in runs), f"overlap: the three drivers' tokens differ (seed "
              f"{100 + trial})")
    for name, trials in runs.items():
        rtf = [wall / (tokens.shape[1] / codec_cfg.frame_rate) for wall, _, tokens in trials]
        timed = rtf[1:]
        lm = [t[1] for t in trials[1:]]
        voc = [t[0] - t[1] for t in trials[1:]]
        log("overlap", f"{name}: RTF best {min(timed):.4f} median {float(np.median(timed)):.4f} "
            f"of {OVERLAP_TRIALS} ({', '.join(f'{x:.4f}' for x in timed)}; warm-up "
            f"{rtf[0]:.4f}); LM s median {float(np.median(lm)):.4f}"
            f"{' (the in-loop feeds issued included)' if name == 'overlapped' else ''}, vocode s "
            f"{'(the tail after the LM) ' if name == 'overlapped' else ''}median "
            f"{float(np.median(voc)):.4f}; {trials[1][2].shape[1]} frames; on {smi}")
    session = codec.start_stream(max_step_frames=OVERLAP_CHUNK)
    piece = shift(runs["serial"][1][2][:, :OVERLAP_CHUNK])
    host = []
    for _ in range(OVERLAP_TRIALS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.feed_async(piece, pad_to=OVERLAP_CHUNK)
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    log("overlap", f"one {OVERLAP_CHUNK}-frame feed_async takes {1e3 * float(np.median(host[1:])):.2f} "
        f"ms of host time to issue (median of {OVERLAP_TRIALS}); the overlapped driver issues "
        f"{-(-N_FRAMES // OVERLAP_CHUNK)} inside its LM s; on {smi}")


# --------------------------------------------------------------------------
# Phase: graph (the decode loop as CUDA graphs)
# --------------------------------------------------------------------------

GRAPH_SERVE_REQUESTS = 16  # seeded requests through each 16-row batcher
GRAPH_SERVE_FRAMES = 64
GRAPH_TURNS = ("graph", "eager", "eager", "graph")  # timed generate calls, in turns


def counted_generate(torch, engine, prompt, sampling, n_frames: int, **kw):
    """engine.generate, timed to its return (which waits for its last
    read), with the host reads it made (`device.Fetch.get` calls)."""
    from fish_speech_tpu_torch.device import Fetch

    reads, get = [0], Fetch.get

    def counted(fetch):
        reads[0] += 1
        return get(fetch)

    Fetch.get = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, state = engine.generate(prompt, max_new_tokens=n_frames, sampling=sampling, **kw)
        seconds = time.perf_counter() - t0
    finally:
        Fetch.get = get
    return res, state, seconds, reads[0]


def chunk_profile(torch, engine, state, sampling, horizon: int, chunks: int) -> dict:
    """A frame's wall ms (decode_chunk calls back to back, to a sync, no
    profiler) against its device ms and kernel launches (the same calls
    under torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    def run(state):
        for _ in range(chunks):
            state = engine.decode_chunk(state, sampling, horizon)[0]
        torch.cuda.synchronize()
        return state

    state = run(state)  # warm
    t0 = time.perf_counter()
    state = run(state)
    wall = (time.perf_counter() - t0) * 1e3 / (chunks * horizon)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state = run(state)
    kernels = device_kernels(prof)
    n = chunks * horizon
    return {"wall_ms": wall, "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / n,
            "launches": sum(e.count for e in kernels) / n, "kernels": kernels, "frames": n}


def graph_batch1(torch, np, label: str, graph, eager, n_frames: int, smi: str,
                 profile_horizon: int, cont_frames: int, turns=GRAPH_TURNS) -> dict:
    """Batch-1 generate under the captured loop and eagerly on one seed:
    codes identical, and those of a cont_frames continuation after a
    rewind to the prompt (the same stream); captures one per key over
    more requests; the kernels' device counters against the replays'
    frames; frames/s in `turns` and a frame's wall against device ms of
    one decode_chunk(profile_horizon) under each."""
    from fish_speech_tpu_torch.ops import decode_attention as da
    from fish_speech_tpu_torch.ops import decode_stack as ds
    from fish_speech_tpu_torch.ops import fast_frame as ff
    from fish_speech_tpu_torch.ops import slow_step as ss
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    check(graph.graphs is not None and eager.graphs is None,
          f"graph {label}: decode_impl auto on CUDA has no graphs, or eager has")
    cfg = graph.cfg
    prompt = main_prompt(np, cfg)
    sampling = SamplingArgs(**SAMPLING)
    t0 = time.perf_counter()
    for eng in (graph, eager):  # warm: the graph's keys captured
        eng.generate(prompt, max_new_tokens=n_frames, sampling=sampling, seed=0)
        cont = eng.rewind(eng.init_state(0), 0)
        eng.generate(prompt[:, :16], max_new_tokens=cont_frames, sampling=sampling,
                     state=cont, conditioning_offset=PROMPT_LEN)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    captures = graph.graphs.captures
    got = {}
    for mode, eng in (("graph", graph), ("eager", eager)):
        res, state, _, _ = counted_generate(torch, eng, prompt, sampling, n_frames, seed=11)
        state = eng.rewind(state, PROMPT_LEN)
        cont, _ = eng.generate(prompt[:, :16], max_new_tokens=cont_frames, sampling=sampling,
                               state=state, conditioning_offset=PROMPT_LEN)
        got[mode] = [res.semantic, res.tokens, cont.semantic, cont.tokens]
    same = all(np.array_equal(a, b) for a, b in zip(got["graph"], got["eager"]))
    check(same, f"graph {label}: the codes under the graph differ from eager's on seed 11 "
          f"(first {got['graph'][0][:8]} vs {got['eager'][0][:8]})")
    check(got["graph"][1].shape[1] == n_frames, f"graph {label}: {got['graph'][1].shape[1]} "
          f"frames, expected {n_frames}")

    # more requests, each from a new state: no capture
    budget = n_frames - 1
    frames_run = sum(h for h, _ in graph.chunk_plan(budget))
    sync = graph.sync_state
    before = (ds.launch_counts("cuda", sync), graph.graphs.frames, graph.graphs.replays,
              ss.launches, ff.launches, ss.int8_launches, ff.int8_launches, da.launches)
    times, reads = {"graph": [], "eager": []}, []
    for mode in turns:
        eng = graph if mode == "graph" else eager
        res, _, s, r = counted_generate(torch, eng, prompt, sampling, n_frames,
                                        seed=20 + len(reads))
        times[mode].append(s)
        reads.append(r)
    check(graph.graphs.captures == captures, f"graph {label}: {graph.graphs.captures - captures} "
          "captures for requests of keys captured already")
    (p0, s0), f0, r0, ss0, ff0, ss8, ff8, da0 = before
    p1, s1 = ds.launch_counts("cuda", sync)
    replayed = graph.graphs.frames - f0
    c = cfg.num_codebooks
    int8 = graph.quantize_int8
    slow, fast = int(graph.use_fused_slow), int(graph.use_fused_fast)
    n_graph = turns.count("graph")
    check(replayed == n_graph * frames_run and graph.graphs.replays - r0 == n_graph * len(
        graph.chunk_plan(budget)), f"graph {label}: {replayed} frames replayed, expected "
          f"{n_graph * frames_run}")
    # per frame: the slow step's persistent launch, then a persistent and a
    # sampler launch a codebook step (the kernels count them themselves, on
    # the graph engine's own sync state; the eager engine has its own)
    check(p1 - p0 == replayed * (slow + fast * c) and s1 - s0 == replayed * fast * c,
          f"graph {label}: the persistent kernels counted {p1 - p0} persistent and {s1 - s0} "
          f"sampler launches on the graph engine, expected {replayed * (slow + fast * c)} and "
          f"{replayed * fast * c} for {replayed} replayed frames")
    frames_both = n_graph * frames_run + turns.count("eager") * decode_frames(eager, budget)
    got_py = (ss.launches - ss0, ff.launches - ff0, ss.int8_launches - ss8,
              ff.int8_launches - ff8, da.launches - da0)
    want_py = (frames_both * slow, frames_both * fast, frames_both * slow * int8,
               frames_both * fast * int8, frames_both * (1 - slow) * cfg.n_layer)
    check(got_py == want_py, f"graph {label}: the wrappers counted (slow step, fast frame, "
          f"their int8 bodies, decode attention) {got_py}, expected {want_py}")
    fps = {m: n_frames / np.mean(v) for m, v in times.items()}
    prof = {m: chunk_profile(torch, e, e.prefill(e.init_state(3), prompt, sampling)[0],
                             sampling, profile_horizon, 1)
            for m, e in (("graph", graph), ("eager", eager))}
    for mode in ("graph", "eager"):
        p = prof[mode]
        log("graph", f"{label} {mode}: generate {n_frames} frames {fps[mode]:.1f} frames/s "
            f"(mean of {turns.count(mode)}, in turns {'/'.join(turns)}); a frame {p['wall_ms']:.3f} ms wall against "
            f"{p['device_ms']:.3f} ms of device kernels ({p['launches']:.1f} launches a frame "
            f"under torch.profiler, {p['frames']} frames of decode_chunk({profile_horizon})), "
            f"device busy {100 * p['device_ms'] / p['wall_ms']:.1f}% [{smi}]")
    log("graph", f"{label}: codes identical under the graph and eager on seed 11 "
        f"({n_frames} frames, and {cont_frames} after a rewind to the {PROMPT_LEN}-token "
        f"prefix); {graph.graphs.captures} captures for keys "
        f"{sorted(k[1:] for k in graph.graphs.graphs)} in {graph.graphs.capture_s:.2f}s "
        f"(warm-up runs included; both engines' warm-up {warm_s:.2f}s), none for "
        f"{len(turns)} more requests; host reads a generate call: {reads} ({len(graph.chunk_plan(budget))} "
        f"chunks + the first frame); device counters: {p1 - p0} persistent + {s1 - s0} sampler "
        f"launches for {replayed} replayed frames")
    return {"fps": fps, "profile": prof, "captures": graph.graphs.captures,
            "capture_s": graph.graphs.capture_s, "reads": reads}


def graph_decode_attention(torch, np, graph, eager, n_frames: int, smi: str) -> dict:
    """The unfused batch-1 path (decode attention) under the graph: codes
    as eager's (graph_batch1), and decode attention's launches from the
    replays as torch.profiler sees them on the card."""
    from torch.profiler import ProfilerActivity, profile

    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    # a frame of this path is ~3900 launches: 8 frames profiled, the
    # continuation's 8 the same loop; one timed call a mode (eager ~9 fps)
    out = graph_batch1(torch, np, "batch-1 xla", graph, eager, n_frames, smi, 8, 9,
                       turns=("graph", "eager"))
    sampling = SamplingArgs(**SAMPLING)
    state, _, _ = graph.prefill(graph.init_state(5), main_prompt(np, graph.cfg), sampling)
    f0, r0 = graph.graphs.frames, graph.graphs.replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.decode_chunk(state, sampling, 8)
        torch.cuda.synchronize()
    frames = graph.graphs.frames - f0
    n = sum(e.count for e in device_kernels(prof) if "decode_attention_kernel" in e.key)
    check(graph.graphs.replays - r0 == 1 and n == frames * graph.cfg.n_layer,
          f"graph batch-1 xla: torch.profiler saw {n} decode_attention_kernel launches in one "
          f"replay of {frames} frames, expected {frames * graph.cfg.n_layer}")
    log("graph", f"batch-1 xla: one replay of {frames} frames launched decode_attention_kernel "
        f"{n} times on the card (torch.profiler), {graph.cfg.n_layer} a frame")
    out["decode_attention_replayed"] = n
    return out


def graph_serving(torch, np, label: str, engine, eager, codec, smi: str) -> dict:
    """16-row serving through TTSPipeline(...).create_batcher(16, 16), as
    the server phase builds it, on the engine (graphs) and its eager
    twin: GRAPH_SERVE_REQUESTS seeded requests at once, each one's codes
    identical under both; the row kernel's and the batched frame's
    launches counted by the kernels against the replays' frames;
    aggregate frames/s and a frame's wall against device ms."""
    from fish_speech_tpu_torch.config import WhichLM
    from fish_speech_tpu_torch.ops import decode_stack as ds
    from fish_speech_tpu_torch.ops import slow_step as ss
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs
    from fish_speech_tpu_torch.pipeline import TTSPipeline

    cfg = engine.cfg
    sampling = SamplingArgs(**SAMPLING)
    rng = np.random.default_rng(11)
    prompts = [np.concatenate([rng.integers(1000, 90000, size=(1, PROMPT_LEN)),
                               rng.integers(0, cfg.codebook_size,
                                            size=(cfg.num_codebooks, PROMPT_LEN))]).astype(np.int32)
               for _ in range(GRAPH_SERVE_REQUESTS)]
    codes, out = {}, {}
    for mode, base in (("graph", engine), ("eager", eager)):
        pipeline = TTSPipeline(base, codec, StandInTokenizer(cfg.codebook_size), WhichLM.FISH_1_5)
        pipeline.default_sampling = sampling
        batcher = pipeline.create_batcher(SERVE_ROWS, SERVE_HORIZON)
        eng = batcher.engine
        check((eng.graphs is not None) == (mode == "graph"), f"graph {label}: the {mode} "
              "batcher's engine has the wrong decode loop")
        try:
            t0 = time.perf_counter()
            batcher.warmup()
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            counts = (ds.rows_launch_count("cuda", eng.sync_state),
                      ds.frame_launch_count("cuda", eng.sync_state),
                      eng.graphs.frames if eng.graphs else 0)
            t0 = time.perf_counter()
            reqs = [batcher.submit([p], 0, GRAPH_SERVE_FRAMES, sampling=sampling, seed=3000 + i)
                    for i, p in enumerate(prompts)]
            got = []
            for req in reqs:
                chunks = list(req.iter_chunks(timeout=WAIT_S))
                got.append(np.concatenate([chunks[0].semantic[None], chunks[0].tokens]))
            seconds = time.perf_counter() - t0
            rows = ds.rows_launch_count("cuda", eng.sync_state) - counts[0]
            frames = ds.frame_launch_count("cuda", eng.sync_state) - counts[1]
            replayed = (eng.graphs.frames - counts[2]) if eng.graphs else None
            state = eng.init_state(0)
            state, _, _ = eng.prefill_rows(state, prompts, sampling, 0,
                                           per_row=[(sampling, 4000 + i) for i in
                                                    range(SERVE_ROWS)])
            prof = chunk_profile(torch, eng, state, sampling, SERVE_HORIZON, 2)
        finally:
            batcher.shutdown()
        codes[mode] = got
        n = sum(c.shape[1] for c in got)
        out[mode] = dict(fps=n / seconds, profile=prof, frames=n, ticks=batcher.ticks,
                         warm_s=warm_s, captures=eng.graphs.captures if eng.graphs else 0,
                         capture_s=eng.graphs.capture_s if eng.graphs else 0.0)
        if mode == "graph":
            per_step = ss.rows_launches_per_step(cfg.n_layer, SERVE_ROWS)
            check(replayed > 0 and frames == replayed and rows == per_step * replayed,
                  f"graph {label}: the kernels counted {rows} row-kernel and {frames} batched "
                  f"frame launches over {replayed} replayed frames ({per_step} row launches a "
                  "step)")
            out[mode].update(replayed=replayed, rows_launches=rows, frame_launches=frames)
    same = all(np.array_equal(a, b) for a, b in zip(codes["graph"], codes["eager"]))
    check(same, f"graph {label}: a seeded request's codes differ under the graph and eager")
    for mode in ("graph", "eager"):
        o, p = out[mode], out[mode]["profile"]
        log("graph", f"{label} {mode}: {GRAPH_SERVE_REQUESTS} seeded requests of "
            f"{GRAPH_SERVE_FRAMES} frames at once, {o['frames']} frames in {o['ticks']} ticks, "
            f"{o['fps']:.1f} frames/s aggregate; a {SERVE_ROWS}-row frame {p['wall_ms']:.3f} ms "
            f"wall against {p['device_ms']:.3f} ms of device kernels ({p['launches']:.1f} "
            f"launches a frame under torch.profiler), device busy "
            f"{100 * p['device_ms'] / p['wall_ms']:.1f}% [{smi}]")
    g = out["graph"]
    log("graph", f"{label}: every seeded request's codes identical under the graph and eager; "
        f"{g['captures']} captures in {g['capture_s']:.2f}s (batcher warm-up {g['warm_s']:.2f}s); "
        f"the kernels counted {g['rows_launches']} row-kernel and {g['frame_launches']} batched "
        f"frame launches for {g['replayed']} replayed frames")
    return out


def run_graph(torch, np, fused, unfused, int8, loud, smi) -> dict:
    """The decode loop as CUDA graphs (generate/graph.py), each path
    against its eager twin (`sibling(decode_impl="eager")`): batch-1
    `auto` bf16 and int8 (128 frames), batch-1 `xla` (32 frames, decode
    attention), 16-row serving bf16 and int8 through create_batcher(16,
    16), and the overlapped driver at chunk 64 on the graph."""
    from fish_speech_tpu_torch.generate.overlap import generate_vocode_overlapped, output_shift
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    t0 = time.perf_counter()
    out = {}
    for label, eng in (("batch-1 auto", fused), ("batch-1 auto int8", int8["batch1"])):
        out[label] = graph_batch1(torch, np, label, eng, eng.sibling(decode_impl="eager"),
                                  N_FRAMES, smi, OVERLAP_CHUNK, N_FRAMES // 2)
    out["batch-1 xla"] = graph_decode_attention(
        torch, np, unfused, unfused.sibling(decode_impl="eager", slow_impl="xla",
                                            fast_frame_impl="xla"), N_FRAMES_UNFUSED, smi)
    for label, eng in (("serving", fused), ("serving int8", int8["batch1"])):
        # the server phase's pipeline engine: cache 512, bucket 64
        kw = dict(cache_len=SERVE_CACHE, prompt_buckets=(64,))
        out[label] = graph_serving(torch, np, label, eng.sibling(**kw),
                                   eng.sibling(decode_impl="eager", **kw), loud, smi)
    # the overlapped driver on the batch-1 engine's graphs: a first call
    # captures its horizon's (its last chunk is budget-cut: the masked one)
    sampling = SamplingArgs(**SAMPLING)
    prompt = main_prompt(np, fused.cfg)

    def overlapped(seed):
        return generate_vocode_overlapped(fused, loud, prompt, sampling=sampling,
                                          max_new_tokens=N_FRAMES, seed=seed,
                                          chunk=OVERLAP_CHUNK, shift_fn=output_shift(fused.lm))

    overlapped(13)
    r0, c0 = fused.graphs.replays, fused.graphs.captures
    _, res, _ = overlapped(12)
    ref, _ = fused.sibling(decode_impl="eager").generate(prompt, max_new_tokens=N_FRAMES,
                                                         sampling=sampling, seed=12)
    replays = fused.graphs.replays - r0
    check(replays == -(-(N_FRAMES - 1) // OVERLAP_CHUNK) and fused.graphs.captures == c0
          and np.array_equal(res.tokens, ref.tokens) and np.array_equal(res.semantic,
                                                                        ref.semantic),
          f"graph overlap: {replays} replays, {fused.graphs.captures - c0} captures; tokens "
          "equal to the eager generate's: "
          f"{np.array_equal(res.tokens, ref.tokens)}")
    log("graph", f"overlap: generate_vocode_overlapped at chunk {OVERLAP_CHUNK} ran {replays} "
        f"replays of the batch-1 engine's horizon-{OVERLAP_CHUNK} loops (no capture after its "
        f"first call), tokens equal to the eager generate's on seed 12")
    b1, sv = out["batch-1 auto"], out["serving"]
    log("graph", f"summary [{smi}]: batch-1 auto bf16 {b1['fps']['graph']:.1f} frames/s under "
        f"the graph against {b1['fps']['eager']:.1f} eager; a 16-row serving frame "
        f"{sv['graph']['profile']['wall_ms']:.3f} ms wall under the graph against "
        f"{sv['eager']['profile']['wall_ms']:.3f} ms eager; phase "
        f"{time.perf_counter() - t0:.1f}s")
    return out


def run_ttfa(torch, np, params, cfg, tok, codec, smi) -> None:
    """bench.py::bench_ttfa's path on the port: cache 512, max_frames 16,
    bucket 64; prefill, one 16-frame decode_chunk, one streaming feed,
    timed to the first PCM on the host; TTFA_TRIALS after a warm-up."""
    from fish_speech_tpu_torch.config import WhichLM
    from fish_speech_tpu_torch.generate.engine import LMEngine
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    engine = LMEngine(params, cfg, tok, WhichLM.FISH_1_5, cache_len=SERVE_CACHE,
                      max_frames=TTFA_FRAMES, prompt_buckets=(64,))
    sampling = SamplingArgs(**SAMPLING)
    prompt = main_prompt(np, cfg)

    def first_audio():
        t0 = time.perf_counter()
        state = engine.init_state(0)
        stream = codec.start_stream(max_step_frames=TTFA_FRAMES)
        state, first, _, _ = engine._prefill_raw(state, prompt, sampling)
        frames = [first.cpu().numpy()[0]]
        state, out, valid, steps = engine.decode_chunk(state, sampling, TTFA_FRAMES)
        out, valid, steps = (t.cpu().numpy() for t in (out, valid, steps))
        frames += [out[i, 0] for i in range(int(steps)) if valid[i, 0]]
        pcm = stream.feed(np.stack(frames, axis=1)[1:])[0]
        return time.perf_counter() - t0, pcm

    first_audio()  # warm-up
    ts = []
    for _ in range(TTFA_TRIALS):
        t, pcm = first_audio()
        check(pcm.shape[0] > 0 and bool(np.isfinite(pcm).all()), "ttfa: first audio empty or "
              "not finite")
        ts.append(t)
    log("ttfa", f"prefill + one {TTFA_FRAMES}-frame decode_chunk + one feed, {TTFA_TRIALS} "
        f"trials: p50 {float(np.percentile(ts, 50)):.4f}s p90 "
        f"{float(np.percentile(ts, 90)):.4f}s (min {min(ts):.4f}, max {max(ts):.4f}; "
        f"{pcm.shape[0]} samples of first audio) on {smi}")


# --------------------------------------------------------------------------
# Phase cli: checkpoints from disk, the text front end, the encoder and
# the three CLIs
# --------------------------------------------------------------------------

CLI_FRAMES = 64  # frames a text chunk
CLI_SEED = 7
CLI_VOICE_S = 4.0
CLI_VOICE_RATE = 24000
CLI_PROMPT_TEXT = "The quick brown fox jumps over the lazy dog."
CLI_TEXT = ("Here is the first sentence of the request. "
            "And this second one is prefilled behind the cached speaker prompt.")
CLI_CODE_SHARE = 0.995  # codes of the card's float32 encode equal to the CPU's, at least
TIE_BAND = 1e-3  # a value this close to a half-integer may round either way


class StandInTokenizer:
    """A word-level tokenizer with the ChatML specials and <|semantic:i|>
    at the ids `build_models` uses (<|im_end|> 100011, <|semantic:i|>
    100012 + i, <|semantic|> 5), so that TokenConfig.from_tokenizer gives
    that engine's TokenConfig; words get ids from 1000 on, in the order
    first seen. It has what PromptEncoder calls: encode(text,
    add_special_tokens=False).ids and token_to_id. base: <|voice|>'s id,
    the other specials following it (a vocab of Fish 1.2's 32000 ids
    takes a lower one)."""

    def __init__(self, codebook_size: int, base: int = 100008) -> None:
        self.vocab = {"<|semantic|>": 5, "<|voice|>": base, "<|im_start|>": base + 2,
                      "<|im_end|>": base + 3}
        self.vocab.update({f"<|semantic:{i}|>": base + 4 + i for i in range(codebook_size)})
        self.words = {}

    def token_to_id(self, token: str):
        return self.vocab.get(token)

    def encode(self, text: str, add_special_tokens: bool = False):
        import types

        ids = []
        for special, word in re.findall(r"(<\|[^|]*\|>)|(\w+|[^\w\s]+)", text):
            if special:
                ids.append(self.vocab[special])
            else:
                ids.append(self.words.setdefault(word, 1000 + len(self.words)))
        return types.SimpleNamespace(ids=ids)


def voice_wav(np, path) -> None:
    """A seeded 4-second 24 kHz mono voice: harmonics of a gliding 140 Hz
    tone under an envelope, plus noise, peaking near 0.3, as 16-bit PCM."""
    from fish_speech_tpu_torch.audio.wav import write_pcm_as_wav

    rng = np.random.default_rng(CLI_SEED)
    t = np.arange(int(CLI_VOICE_S * CLI_VOICE_RATE)) / CLI_VOICE_RATE
    phase = 2 * np.pi * (140 * t + 15 * np.sin(2 * np.pi * 0.7 * t))
    x = sum(np.sin(k * phase + rng.uniform(0, 2 * np.pi)) / k for k in range(1, 6))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t) ** 2) + 0.1 * rng.normal(size=t.shape)
    x = 0.3 * x / np.abs(x).max()
    with open(path, "wb") as f:
        write_pcm_as_wav(f, x.astype(np.float32), CLI_VOICE_RATE)


def encode_group_inputs(torch, codec, audio):
    """Each FSQ group's input (1, T', dim / G) for one row of audio: the
    encode's arithmetic (FireflyCodec.encode, quantizer_encode) up to the
    groups' project_in."""
    from fish_speech_tpu_torch.models.codec.conv import fish_conv1d
    from fish_speech_tpu_torch.models.codec.convnext import convnext_block, convnext_encoder

    cfg, p = codec.cfg, codec.params
    with torch.no_grad():
        z = convnext_encoder(codec.spec_transform(audio), p["backbone"], cfg.backbone,
                             cfg.version)
        for i, factor in enumerate(cfg.quantizer.downsample_factor):
            layer = p["quantizer"]["downsample"][i]
            z = fish_conv1d(z, layer["conv"], stride=factor, version=cfg.version)
            z = convnext_block(z, layer["block"], version=cfg.version)
    return torch.chunk(z.transpose(1, 2), cfg.quantizer.n_groups, dim=-1)


def spread_encoder(torch, codec, audio) -> list:
    """Standardise each group's project_in in place so that each of its
    outputs has mean 0 and standard deviation 1 over `audio`'s frames;
    returns the scales. At the init's scale (0.02) they lie within ~0.1
    of zero, every dimension rounds to the middle of the grid and no
    code can flip, whatever the features' rounding: a trained codec's
    spread over the grid, and so do these then."""
    from fish_speech_tpu_torch.models.codec import grfsq

    scales = []
    with torch.no_grad():
        for x, gp in zip(encode_group_inputs(torch, codec, audio),
                         codec.params["quantizer"]["rvqs"]):
            z = grfsq._linear(x, gp["project_in"]).flatten(0, 1)  # (T', d)
            mean, std = z.mean(0), z.std(0)
            gp["project_in"]["w"].div_(std)
            gp["project_in"]["b"].sub_(mean).div_(std)
            scales += (1.0 / std).tolist()
    return scales


def encode_values(torch, codec, audio):
    """(G*Q, T', d) float64: the value each dimension of each code of
    codec.encode(audio) rounds, for one row, by the encode's arithmetic:
    stage q of a group rounds the bound of its residual / scale."""
    from fish_speech_tpu_torch.models.codec import fsq, grfsq

    q = codec.cfg.quantizer
    out = []
    with torch.no_grad():
        for x, gp in zip(encode_group_inputs(torch, codec, audio),
                         codec.params["quantizer"]["rvqs"]):
            residual = fsq.bound(grfsq._linear(x, gp["project_in"]), q.levels)
            for scale in grfsq._scales(q.levels, q.n_codebooks):
                out.append(fsq.bound(residual / scale, q.levels)[0])
                codes, _ = fsq.fsq_forward(residual / scale, q.levels)
                residual = residual - codes * scale
    return torch.stack(out).double().cpu().numpy()


def codes_of_values(np, values, levels):
    """The FSQ indices that `values` (..., d) round to (half to even)."""
    basis = np.cumprod([1] + list(levels[:-1]))
    return ((np.round(values) + np.array([lv // 2 for lv in levels])) * basis).sum(-1)


def near_ties(np, values, n_codebooks: int):
    """(G*Q, T') flags: a dimension of the code lies within TIE_BAND of a
    half-integer, in its stage or an earlier one of its group (whose
    flip moves this stage's residual)."""
    tie = (np.abs(np.abs(values - np.floor(values)) - 0.5) < TIE_BAND).any(-1)
    g = tie.reshape(-1, n_codebooks, tie.shape[-1])
    return np.logical_or.accumulate(g, axis=1).reshape(tie.shape)


def logged(torch, fn, *args, phase: str = "cli"):
    """fn(*args) in-process, its prints logged under `phase`; returns
    (its result, its seconds to the card's last work)."""
    import contextlib

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        log(phase, f"  | {line}")
    return result, seconds


def trees_equal(torch, got, ref) -> bool:
    if isinstance(ref, dict):
        return set(got) == set(ref) and all(trees_equal(torch, got[k], ref[k]) for k in ref)
    if isinstance(ref, (list, tuple)):
        return len(got) == len(ref) and all(trees_equal(torch, a, b) for a, b in zip(got, ref))
    return got.dtype == ref.dtype and got.device == ref.device and torch.equal(got, ref)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def run_cli(torch, np, params, cfg, tok, codec_cfg, smi) -> None:
    """A user's voice-cloning path on checkpoints read from disk: write
    the full-width Fish-1.5 bf16 LM (the main path's weights) and a
    float32 Firefly-1.5 codec (seed 1) in the upstream names, read both
    back bit-equal onto the card, encode a reference WAV through the
    encoder CLI, generate two text chunks behind that speaker prompt
    through llama_generate's generation function (with a stand-in
    tokenizer), and vocode the codes through the vocoder CLI."""
    import tempfile
    from pathlib import Path

    from fish_speech_tpu_torch.audio.resample import resample
    from fish_speech_tpu_torch.audio.wav import read_wav
    from fish_speech_tpu_torch.cli import encoder, llama_generate, vocoder
    from fish_speech_tpu_torch.config import TokenConfig, WhichLM
    from fish_speech_tpu_torch.device import tree_to
    from fish_speech_tpu_torch.generate.engine import LMEngine
    from fish_speech_tpu_torch.io.checkpoint import (
        FIREFLY_FILES, load_firefly_params, load_lm_params, save_firefly_params,
        save_lm_params)
    from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec, init_firefly_params
    from fish_speech_tpu_torch.ops import fast_frame as ff
    from fish_speech_tpu_torch.ops import prefill_attention as pa
    from fish_speech_tpu_torch.ops import slow_step as ss
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    lm = WhichLM.FISH_1_5
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        wav = d / "voice.wav"
        voice_wav(np, wav)
        audio, sr = read_wav(str(wav))
        audio44 = resample(audio, sr, codec_cfg.spec_transform.sample_rate)
        # 1. write
        codec32 = init_firefly_params(codec_cfg, seed=1, dtype=torch.float32, device="cuda")
        spread = spread_encoder(torch, FireflyCodec(codec32, codec_cfg), audio44)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_lm_params(d / "model.safetensors", params, cfg)
        (d / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
        save_firefly_params(d / FIREFLY_FILES[0], codec32, codec_cfg)
        write_s = time.perf_counter() - t0
        n_bytes = sum(f.stat().st_size for f in d.iterdir())
        log("cli", f"wrote model.safetensors (bf16, {tree_bytes(params)} bytes of tensors), "
            f"config.json and {FIREFLY_FILES[0]} (float32, project_in standardised on the "
            f"voice, its columns scaled by {min(spread):.1f}-{max(spread):.1f}): {n_bytes} "
            f"bytes in {write_s:.2f}s")

        # 2. read back onto the card
        t0 = time.perf_counter()
        loaded = load_lm_params(d, cfg)
        torch.cuda.synchronize()
        lm_load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        codec_loaded = load_firefly_params(d, codec_cfg)
        torch.cuda.synchronize()
        codec_load_s = time.perf_counter() - t0
        check(trees_equal(torch, loaded, params), "cli: the LM read back differs from the "
              "in-memory parameters")
        check(trees_equal(torch, codec_loaded, codec32), "cli: the codec read back differs "
              "from the in-memory float32 codec")
        log("cli", f"load_lm_params {lm_load_s:.2f}s, load_firefly_params {codec_load_s:.2f}s "
            f"onto the card; every leaf bit-equal to the in-memory tree; {smi}")

        # 3. encode a reference voice through the encoder CLI, with TF32
        # allowed process-wide (PyTorch's default for cuDNN): the encode
        # turns it off for itself
        card = FireflyCodec(codec_loaded, codec_cfg)
        switches = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            _, enc_cli_s = logged(torch, encoder.main, [
                "--input", str(wav), "--checkpoint", str(d), "--out-path", str(d / "voice.npy")])
            t0 = time.perf_counter()
            again = card.encode(audio44)[0]
            torch.cuda.synchronize()
            enc_s = time.perf_counter() - t0
            values_tf32 = encode_values(torch, card, audio44)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = switches
        codes = np.load(d / "voice.npy")
        n_code = card.frames_for_samples(audio44.shape[0])
        n_cb = codec_cfg.quantizer.num_semantic_codebooks
        check(codes.dtype == np.uint32 and codes.shape == (n_cb, n_code),
              f"cli: encoder codes {codes.dtype} {codes.shape}, expected uint32 ({n_cb}, {n_code})")
        check(int(codes.max()) < cfg.codebook_size, "cli: a code outside [0, 1024)")
        tf32 = card.encode(audio44, allow_tf32=True)[0]
        values = encode_values(torch, card, audio44)
        cpu = FireflyCodec(tree_to(codec32, "cpu"), codec_cfg, device="cpu")
        t0 = time.perf_counter()
        ref = cpu.encode(audio44)[0]
        cpu_enc_s = time.perf_counter() - t0
        ref_values = encode_values(torch, cpu, audio44)
        levels = codec_cfg.quantizer.levels
        check(np.array_equal(codes_of_values(np, ref_values, levels), ref),
              "cli: the CPU encode's values do not round to its codes")
        tie = near_ties(np, ref_values, codec_cfg.quantizer.n_codebooks)
        differ = codes != ref
        share = float(1.0 - differ.mean())
        share_tf32 = float((tf32 == ref).mean())
        distinct = len(np.unique(ref))
        check(np.array_equal(again, codes), "cli: two encodes on the card differ")
        check(not (differ & ~tie).any(), f"cli: {int((differ & ~tie).sum())} codes of the "
              f"card's float32 encode differ from the CPU's at least {TIE_BAND} from a tie")
        check(share >= CLI_CODE_SHARE, f"cli: the card's float32 encode agrees with the CPU's "
              f"on {share:.4f} of the codes, below {CLI_CODE_SHARE}")
        check(share_tf32 < share, f"cli: with TF32 the encode agrees with the CPU's on "
              f"{share_tf32:.5f} of the codes, no fewer than without ({share:.5f})")
        log("cli", f"encoder CLI: {CLI_VOICE_S:.0f}s {sr} Hz 16-bit WAV -> resample to "
            f"{codec_cfg.spec_transform.sample_rate} -> codes {codes.shape}, {distinct} distinct "
            f"in [0, {int(codes.max()) + 1}); CLI {enc_cli_s:.2f}s (codec load included), encode "
            f"{enc_s:.3f}s (RTF {enc_s / CLI_VOICE_S:.4f}), CPU encode {cpu_enc_s:.2f}s; codes "
            f"equal to the CPU encode: {share:.5f} with TF32 off ({int(differ.sum())} differ, "
            f"{int(tie.sum())} of {tie.size} within {TIE_BAND} of a tie, none outside), "
            f"{share_tf32:.5f} with TF32 on; values before rounding vs the CPU's: max "
            f"|diff| {np.abs(values - ref_values).max():.2e} TF32 off, "
            f"{np.abs(values_tf32 - ref_values).max():.2e} TF32 on; {smi}")

        # 4. generate two chunks behind the speaker prompt
        stand_in = StandInTokenizer(cfg.codebook_size)
        token_cfg = TokenConfig.from_tokenizer(lm, stand_in, cfg)
        check(token_cfg == tok, f"cli: the stand-in tokenizer gives {token_cfg}, not {tok}")
        args = llama_generate.build_parser().parse_args([
            "--checkpoint", str(d), "--text", CLI_TEXT, "--prompt-tokens", str(d / "voice.npy"),
            "--prompt-text", CLI_PROMPT_TEXT, "--max-new-tokens", str(CLI_FRAMES),
            "--seed", str(CLI_SEED)])
        n_cond, prompts = llama_generate.build_prompts(stand_in, cfg, lm, args)
        check(len(prompts) == 2, f"cli: {len(prompts)} text chunks, expected 2")
        first = prompts[0]
        at = [i for i in range(first.shape[1] - n_code + 1)
              if np.array_equal(first[1:, i:i + n_code], codes)]
        check(len(at) == 1 and np.array_equal(first[0, at[0]:at[0] + n_code],
                                              100012 + codes[0].astype(np.int64)),
              "cli: the first chunk's prompt does not hold the speaker's codes verbatim, with "
              "<|semantic:0|> + row 0 in the semantic row")
        engine = LMEngine(loaded, cfg, token_cfg, lm)
        check(engine.use_fused_slow and engine.use_fused_fast, "cli: the CLI's engine is not "
              "on the fused path")
        chunks = []
        generate = engine.generate

        def recorded(prompt, **kw):
            before = pa.launches
            out = generate(prompt, **kw)
            chunks.append((kw["conditioning_offset"], pa.launches - before, prompt.shape[-1]))
            return out

        engine.generate = recorded
        # the CLI's decode loops captured outside the count
        generate(prompts[0], max_new_tokens=args.max_new_tokens, seed=0, sampling=SamplingArgs(
            temp=args.temp, top_p=args.top_p, top_k=args.top_k,
            repetition_penalty=args.repetition_penalty))
        for m in (pa, ss, ff):
            m.launches = 0
        cli_codes, gen_s = logged(torch, llama_generate.generate_codes, stand_in, engine, args)
        launches = {"prefill_attention": pa.launches, "fused_slow_step": ss.launches,
                    "fused_fast_frame": ff.launches}
        steps = 2 * decode_frames(engine, CLI_FRAMES - 1)
        want = {"prefill_attention": 2 * cfg.n_layer, "fused_slow_step": steps,
                "fused_fast_frame": steps}
        check(launches == want, f"cli: launches {launches}, expected {want}")
        check(chunks[0][0] == 0 and chunks[1][0] == n_cond > 0 and chunks[1][1] == cfg.n_layer,
              f"cli: chunks (offset, prefill launches, prompt length) {chunks}; the second "
              f"should prefill at offset {n_cond}")

        ref_engine = LMEngine(params, cfg, tok, lm)
        sampling = SamplingArgs(temp=args.temp, top_p=args.top_p, top_k=args.top_k,
                                repetition_penalty=args.repetition_penalty)
        state = ref_engine.init_state(CLI_SEED)
        r1, state = ref_engine.generate(prompts[0], max_new_tokens=CLI_FRAMES,
                                        sampling=sampling, state=state)
        state = ref_engine.rewind(state, n_cond)
        r2, _ = ref_engine.generate(prompts[1], max_new_tokens=CLI_FRAMES, sampling=sampling,
                                    state=state, conditioning_offset=n_cond)
        by_hand = np.concatenate([r1.tokens, r2.tokens], axis=1)
        check(cli_codes.shape == (cfg.num_codebooks, 2 * CLI_FRAMES)
              and np.array_equal(cli_codes, by_hand),
              f"cli: llama_generate's codes {cli_codes.shape} differ from the in-memory "
              f"engine's {by_hand.shape}")
        np.save(d / "codes.npy", cli_codes)
        audio_s = cli_codes.shape[1] / codec_cfg.frame_rate
        log("cli", f"llama_generate: 2 chunks of {CLI_FRAMES} frames behind a {n_cond}-token "
            f"conditioning (system prompt + speaker, {n_code} code frames), prompts "
            f"{[c[2] for c in chunks]} tokens at offsets {[c[0] for c in chunks]}; codes equal "
            f"to the in-memory engine's token for token; launches {json.dumps(launches)}; "
            f"{gen_s:.3f}s for {audio_s:.3f}s of audio (RTF {gen_s / audio_s:.4f}); {smi}")
        del engine, ref_engine, loaded

        # 5. vocode through the vocoder CLI
        out = d / "out.wav"
        _, voc_cli_s = logged(torch, vocoder.main, [
            "--input", str(d / "codes.npy"), "--checkpoint", str(d), "--out-path", str(out)])
        n_samples = cli_codes.shape[1] * codec_cfg.samples_per_frame
        with wave.open(str(out)) as w:
            check((w.getnchannels(), w.getsampwidth(), w.getframerate(), w.getnframes())
                  == (1, 2, codec_cfg.spec_transform.sample_rate, n_samples),
                  "cli: the vocoder's WAV header")
        pcm, _ = read_wav(str(out))
        check(pcm.shape == (n_samples,) and bool(np.isfinite(pcm).all()),
              "cli: the vocoder's PCM")
        t0 = time.perf_counter()
        card.decode(cli_codes.astype(np.int32))
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        log("cli", f"vocoder CLI: codes {cli_codes.shape} -> {out.name} ({n_samples} samples, "
            f"header parses, PCM finite); CLI {voc_cli_s:.2f}s (codec load included), decode "
            f"{dec_s:.3f}s; RTF: encoder {enc_s / CLI_VOICE_S:.4f}, llama_generate "
            f"{gen_s / audio_s:.4f}, vocoder {dec_s / audio_s:.4f}; {smi}")


# --------------------------------------------------------------------------
# Phase 6: continuous-batching serving
# --------------------------------------------------------------------------


def serving_requests(np, cfg):
    """The 20 requests: 40-token prompts, 128 frames each; most sample
    with the serving knobs, SERVE_ARGMAX are at temp 0, SERVE_SEEDED carry
    a seed."""
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    rng = np.random.default_rng(7)
    reqs = []
    for i in range(SERVE_REQUESTS):
        prompt = np.concatenate([rng.integers(1000, 90000, size=(1, PROMPT_LEN)),
                                 rng.integers(0, cfg.codebook_size,
                                              size=(cfg.num_codebooks, PROMPT_LEN))])
        knobs = dict(SAMPLING, temp=0.0) if i in SERVE_ARGMAX else SAMPLING
        reqs.append(dict(prompts=[prompt.astype(np.int32)], cond_len=0, max_new=N_FRAMES,
                         sampling=SamplingArgs(**knobs),
                         seed=1000 + i if i in SERVE_SEEDED else None))
    return reqs


def serve(torch, np, batcher, codec, reqs):
    """Submit every request at once, one client thread each; each client
    waits for its codes and vocodes them. Returns, per request, (codes
    (C+1, T), PCM, seconds to the last code, seconds to the PCM, hit_max)."""
    import threading

    out = [None] * len(reqs)
    t0 = time.perf_counter()

    def client(i):
        chunks = list(batcher.submit(**reqs[i]).iter_chunks(timeout=WAIT_S))
        codes = np.concatenate([chunks[0].semantic[None], chunks[0].tokens])
        t_lm = time.perf_counter() - t0
        pcm = codec.decode(codes[1:])
        out[i] = (codes, pcm, t_lm, time.perf_counter() - t0, chunks[0].hit_max)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    check(all(o is not None for o in out) and not any(t.is_alive() for t in threads),
          "serving: a client did not get its codes")
    return out


def serving_run(torch, np, engine, codec, tok, codec_cfg, reqs, label: str):
    """One timed serving run on a warm batcher: checks codes and PCM,
    logs frames/s and RTF p50/p95, returns (results, frames/s, p50)."""
    from fish_speech_tpu_torch.generate.continuous import ContinuousBatcher
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    batcher = ContinuousBatcher(engine, SamplingArgs(**SAMPLING), horizon=SERVE_HORIZON)
    try:
        batcher.warmup()
        torch.cuda.synchronize()
        res = serve(torch, np, batcher, codec, reqs)
    finally:
        batcher.shutdown()
    cfg = engine.cfg
    for i, (codes, pcm, _, _, hit_max) in enumerate(res):
        # a sampled row may draw <|im_end|> (its column is zero, not -inf)
        t = codes.shape[1]
        check(codes.shape[0] == cfg.num_codebooks + 1 and 1 <= t <= N_FRAMES
              and (t == N_FRAMES or not hit_max), f"serving {label} request {i}: codes "
              f"{codes.shape}, hit_max {hit_max}")
        check(bool(((codes[0] >= tok.semantic_start_id) & (codes[0] <= tok.semantic_end_id)).all())
              and bool(((codes[1:] >= 0) & (codes[1:] < cfg.codebook_size)).all()),
              f"serving {label} request {i}: codes out of range")
        check(pcm.shape == (1, t * codec.samples_per_frame) and bool(np.isfinite(pcm).all()),
              f"serving {label} request {i}: pcm {pcm.shape} not finite or misshaped")
    frames = sum(r[0].shape[1] for r in res)
    lm_s = max(r[2] for r in res)
    rtf = np.array([r[3] / (r[0].shape[1] / codec_cfg.frame_rate) for r in res])
    p50, p95 = float(np.percentile(rtf, 50)), float(np.percentile(rtf, 95))
    n_eos = sum(r[0].shape[1] < N_FRAMES for r in res)
    log("serving", f"{label}: {len(res)} requests of up to {N_FRAMES} frames ({n_eos} ended at "
        f"<|im_end|>), codes in range, PCM finite; LM {frames} frames in {lm_s:.3f}s = "
        f"{frames / lm_s:.1f} frames/s aggregate; "
        f"per-request RTF (submit to PCM) p50 {p50:.4f} p95 {p95:.4f}, max {rtf.max():.4f}")
    return res, frames / lm_s, p50


def serve_pcm(torch, np, batcher, reqs):
    """Submit every request at once with deliver_pcm, one client thread
    each, collecting its PCM events and final result. Returns, per
    request, (codes (C+1, T), PCM, seconds to the first PCM event, to the
    last, whether every PCM event came before the result, hit_max)."""
    import threading

    from fish_speech_tpu_torch.generate.continuous import _ChunkResult, _PartialPCM

    out = [None] * len(reqs)
    t0 = time.perf_counter()

    def client(i):
        parts, first, last, final, ordered = [], None, None, None, True
        for ev in batcher.submit(**reqs[i], deliver_pcm=True).iter_events(timeout=WAIT_S):
            if isinstance(ev, _PartialPCM):
                last = time.perf_counter() - t0
                first = last if first is None else first
                ordered = ordered and final is None
                parts.append(ev.pcm)
            elif isinstance(ev, _ChunkResult):
                final = ev
        codes = np.concatenate([final.semantic[None], final.tokens])
        out[i] = (codes, np.concatenate(parts) if parts else np.zeros((0,), np.float32),
                  first, last, ordered and final is not None, final.hit_max)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    check(all(o is not None for o in out) and not any(t.is_alive() for t in threads),
          "central serving: a client did not get its PCM and result")
    return out


def central_run(torch, np, engine, codec, codec32, tok, codec_cfg, reqs, bound16, label: str):
    """One timed central-vocoder serving run on a warm batcher (codec= the
    loud bf16 codec, shift_fn the Fish-1.5 shift): each request's PCM
    events precede its result and concatenate to codec.decode of its
    tokens within the bf16 bound + PCM_I16_ATOL, and are as close to the
    float32 decode as codec.decode is, within ACCURACY_FACTOR (+
    PCM_I16_ATOL), its reference peaking at PCM_MIN_STEPS int16 steps or
    more; logs frames/s, RTF p50/p95 (submit to the last PCM) and TTFA
    p50/p95 (to the first PCM event). Returns (frames/s, RTF p50, TTFA p50)."""
    from fish_speech_tpu_torch.generate.continuous import ContinuousBatcher
    from fish_speech_tpu_torch.generate.overlap import output_shift
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    shift = output_shift(engine.lm)
    batcher = ContinuousBatcher(engine, SamplingArgs(**SAMPLING), horizon=SERVE_HORIZON,
                                codec=codec, shift_fn=shift)
    try:
        check(batcher._central is not None, "central serving: the central vocoder is off")
        batcher.warmup()
        torch.cuda.synchronize()
        res = serve_pcm(torch, np, batcher, reqs)
    finally:
        batcher.shutdown()
    cfg, worst, ratio, low = engine.cfg, 0.0, 0.0, None
    for i, (codes, pcm, first, last, ordered, hit_max) in enumerate(res):
        t = codes.shape[1]
        check(codes.shape[0] == cfg.num_codebooks + 1 and 1 <= t <= N_FRAMES
              and (t == N_FRAMES or not hit_max)
              and bool(((codes[1:] >= 0) & (codes[1:] < cfg.codebook_size)).all()),
              f"central {label} request {i}: codes {codes.shape} out of range, hit_max {hit_max}")
        check(ordered and first is not None, f"central {label} request {i}: a PCM event after "
              "the final result, or none")
        err, err32, own, peak = pcm_accuracy(np, codec, codec32, shift(codes[1:]), pcm,
                                             f"central {label} request {i}")
        worst, ratio = max(worst, err), max(ratio, err32 / own)
        low = peak if low is None else min(low, peak)
        check(err <= bound16 + PCM_I16_ATOL, f"central {label} request {i}: PCM {err:.3e} from "
              f"codec.decode, bound {bound16:.3e} + {PCM_I16_ATOL}")
        check(err32 <= ACCURACY_FACTOR * own + PCM_I16_ATOL, f"central {label} request {i}: "
              f"PCM {err32:.3e} from the float32 decode, codec.decode {own:.3e} (factor "
              f"{ACCURACY_FACTOR}, + {PCM_I16_ATOL})")
    frames = sum(r[0].shape[1] for r in res)
    span = max(r[3] for r in res)
    rtf = np.array([r[3] / (r[0].shape[1] / codec_cfg.frame_rate) for r in res])
    ttfa = np.array([r[2] for r in res])
    p50 = float(np.percentile(rtf, 50))
    log("serving", f"{label}: {len(res)} deliver_pcm requests of up to {N_FRAMES} frames through "
        f"the central vocoder: PCM events before each result, PCM within {worst:.3e} of "
        f"codec.decode (bound {bound16:.3e} + {PCM_I16_ATOL}), at most {ratio:.3f} x "
        f"codec.decode's distance to the float32 decode (limit {ACCURACY_FACTOR}); the "
        f"references peak at {low * 32767:.0f} int16 steps or more; {frames} frames of PCM in "
        f"{span:.3f}s = {frames / span:.1f} frames/s aggregate; per-request RTF (submit to last "
        f"PCM) p50 {p50:.4f} p95 {float(np.percentile(rtf, 95)):.4f}; TTFA (submit to first "
        f"PCM) p50 {float(np.percentile(ttfa, 50)):.4f}s p95 "
        f"{float(np.percentile(ttfa, 95)):.4f}s")
    return frames / span, p50, float(np.percentile(ttfa, 50))


def profile_central(torch, np, engine, codec, ticks: int = 4) -> None:
    """The vocoder's share of a central-vocoding tick's device time: 16
    live rows, `ticks` ticks of one horizon-16 decode chunk and one
    16-row x 16-frame feed of those codes with the int16 conversion, under
    torch.profiler; then the feeds alone on the same codes. Share = the
    feeds' device time over the ticks'."""
    from torch.profiler import ProfilerActivity, profile

    from fish_speech_tpu_torch.generate.continuous import _CentralVocoder
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    prompts = [main_prompt(np, engine.cfg)] * engine.batch_size
    sampling = SamplingArgs(**SAMPLING)
    with torch.inference_mode():
        state, _, _ = engine.prefill_rows(engine.init_state(0), prompts, sampling, 0)
        stream = codec.stream_template(engine.batch_size)

        def tick(state, st, codes=None):
            if codes is None:
                state, out, _, _ = engine.decode_chunk(state, sampling, SERVE_HORIZON)
                codes = out[:, :, 1:].permute(1, 2, 0)  # (B, C, horizon)
            audio, st = codec.decode_step_async(codes, st)
            _CentralVocoder._to_i16(audio)
            return state, st, codes

        tick(state, stream)  # warm
        torch.cuda.synchronize()
        feeds = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            st = stream
            for _ in range(ticks):
                state, st, codes = tick(state, st)
                feeds.append(codes)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof_voc:
            st = stream
            for codes in feeds:
                _, st, _ = tick(None, st, codes)
            torch.cuda.synchronize()
    kernels = device_kernels(prof)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / ticks
    voc_ms = sum(e.self_device_time_total for e in device_kernels(prof_voc)) / 1e3 / ticks
    share = f"{100 * voc_ms / dev_ms:.1f}%" if dev_ms > 0 else "not measured"
    log("profile", f"central vocoding, {engine.batch_size} rows: a tick (decode chunk of "
        f"{SERVE_HORIZON} frames + one {engine.batch_size} x {SERVE_HORIZON}-frame feed) under "
        f"torch.profiler: wall {wall_ms:.2f} ms, device kernels {dev_ms:.3f} ms "
        f"({sum(e.count for e in kernels) / ticks:.0f} launches), of them the vocoder feed "
        f"{voc_ms:.3f} ms = {share} of device time")
    log_top_kernels("profile", kernels, ticks, "tick")


def profile_serving(torch, np, engine, label: str, frames: int = 4) -> None:
    """Where a 16-row decode frame's time goes: torch.profiler over one
    decode chunk of `frames` frames with every row live."""
    from torch.profiler import ProfilerActivity, profile

    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    cfg = engine.cfg
    rng = np.random.default_rng(3)
    prompts = [np.concatenate([rng.integers(1000, 90000, size=(1, PROMPT_LEN)),
                               np.zeros((cfg.num_codebooks, PROMPT_LEN), np.int64)]
                              ).astype(np.int32) for _ in range(engine.batch_size)]
    sampling = SamplingArgs(**SAMPLING)
    state, _, _ = engine.prefill_rows(engine.init_state(0), prompts, sampling, 0)
    state = engine.decode_chunk(state, sampling, frames)[0]  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        engine.decode_chunk(state, sampling, frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    kernels = device_kernels(prof)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / frames
    launches = sum(e.count for e in kernels) / frames
    log("profile", f"serving {label}: {engine.batch_size}-row decode frame under "
        f"torch.profiler: wall {wall_ms:.2f} ms, device kernels {dev_ms:.3f} ms "
        f"({launches:.0f} launches), device busy {100 * dev_ms / wall_ms:.1f}%")
    log_top_kernels("profile", kernels, frames, "frame")


def run_serving(torch, np, serving, codec, codec32, tok, codec_cfg, bound16):
    """The serving phase, in turns: auto, central, slow_xla, xla, int8,
    int8, xla, slow_xla, central, auto. central: serving["auto"] under a
    batcher whose central vocoder vocodes deliver_pcm requests (the
    others vocode on the client). serving["auto"] (bf16): the slow step's row kernel
    and the batched fast frame; serving["slow_xla"]: the unfused slow step
    and the batched fast frame (the A/B that decides `auto`);
    serving["xla"]: the unfused codebook loop; serving["int8"]: the int8
    bodies of the row kernel and the batched frame. The launch counts of
    the first run of each but xla; each seeded request alone on a fresh
    batcher of auto and of int8; profiles. Returns {kernel: launches}:
    the bf16 kernels' on the first auto run, the int8 bodies' on the first
    int8 run."""
    from fish_speech_tpu_torch.generate.continuous import ContinuousBatcher
    from fish_speech_tpu_torch.ops import decode_attention as da
    from fish_speech_tpu_torch.ops import decode_stack as ds
    from fish_speech_tpu_torch.ops import fast_frame as ff
    from fish_speech_tpu_torch.ops import fast_frame_batched as fb
    from fish_speech_tpu_torch.ops import prefill_attention as pa
    from fish_speech_tpu_torch.ops import slow_step as ss
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    reqs = serving_requests(np, serving["auto"].cfg)
    n_layer = serving["auto"].cfg.n_layer
    mods = {"decode_attention": da, "prefill_attention": pa, "fused_slow_step": ss,
            "fused_fast_frame": ff, "fused_fast_frame_batched": fb}
    runs = {"auto": [], "central": [], "slow_xla": [], "xla": [], "int8": []}
    first, counted = {}, {}
    for impl in ("auto", "central", "slow_xla", "xla", "int8", "int8", "xla", "slow_xla",
                 "central", "auto"):
        if impl == "central":
            runs[impl].append(central_run(torch, np, serving["auto"], codec, codec32, tok,
                                          codec_cfg, reqs, bound16,
                                          f"central run {len(runs[impl]) + 1}")[:2])
            continue
        counting = impl != "xla" and impl not in counted
        if counting:
            for m in mods.values():
                m.launches = 0
                m.int8_launches = 0
            ss.rows_launches = ss.rows_int8_launches = 0
            on_card = ds.rows_launch_count("cuda", serving[impl].sync_state)
            frames_on_card = ds.frame_launch_count("cuda", serving[impl].sync_state)
        res, fps, p50 = serving_run(torch, np, serving[impl], codec, tok, codec_cfg, reqs,
                                    f"{impl} run {len(runs[impl]) + 1}")
        if counting:
            launches = {name: m.launches for name, m in mods.items()}
            launches["slow_step_rows"] = ss.rows_launches
            by_kernel = ds.rows_launch_count("cuda", serving[impl].sync_state) - on_card
            by_frame = ds.frame_launch_count("cuda", serving[impl].sync_state) - frames_on_card
            int8 = {name: getattr(m, "int8_launches", 0) for name, m in mods.items()}
            int8["slow_step_rows"] = ss.rows_int8_launches
            log("serving", f"{impl} run 1 launches (warm-up request included) "
                f"{json.dumps(launches)}, of them int8 bodies "
                f"{json.dumps({k: int8[k] for k in ('fused_fast_frame_batched', 'slow_step_rows')})}")
            frames = launches["fused_fast_frame_batched"]  # one a decode step
            rows = 0 if impl == "slow_xla" else ss.rows_launches_per_step(n_layer, SERVE_ROWS)
            want_int8 = impl == "int8"
            check(frames > 0 and frames == by_frame
                  and launches["slow_step_rows"] == rows * frames == by_kernel
                  and (launches["decode_attention"] > 0) == (impl == "slow_xla")
                  and launches["fused_fast_frame"] == 0 and launches["fused_slow_step"] == 0
                  and int8["fused_fast_frame_batched"] == (frames if want_int8 else 0)
                  and int8["slow_step_rows"] == (rows * frames if want_int8 else 0),
                  f"the serving {impl} path launched {launches} (int8 bodies {int8}; the row "
                  f"kernel counted {by_kernel}, the frame kernel {by_frame}) in {frames} decode "
                  "steps")
            counted[impl] = {
                "auto": lambda: launches,
                "slow_xla": lambda: {},
                "int8": lambda: {"fused_fast_frame_batched_int8": int8["fused_fast_frame_batched"],
                                 "slow_step_rows_int8": int8["slow_step_rows"]},
            }[impl]()
            first[impl] = res
        runs[impl].append((fps, p50))
    mean = {k: (sum(f for f, _ in v) / len(v), sum(p for _, p in v) / len(v))
            for k, v in runs.items()}
    verdict = "holds" if mean["auto"][0] >= mean["slow_xla"][0] else "FAILS"
    log("serving", f"A/B (two runs each, in turns): auto (row kernel + batched kernel) "
        f"{mean['auto'][0]:.1f} frames/s, RTF p50 {mean['auto'][1]:.4f}; slow_xla (unfused "
        f"slow step + batched kernel) {mean['slow_xla'][0]:.1f} frames/s, RTF p50 "
        f"{mean['slow_xla'][1]:.4f}; xla (unfused codebook loop) {mean['xla'][0]:.1f} "
        f"frames/s, RTF p50 {mean['xla'][1]:.4f}; int8 auto {mean['int8'][0]:.1f} frames/s, "
        f"RTF p50 {mean['int8'][1]:.4f}; central vocoder (auto engine, PCM frames/s to the "
        f"last PCM) {mean['central'][0]:.1f} frames/s, RTF p50 {mean['central'][1]:.4f}. "
        f"auto's pick of the fused slow step at "
        f"{SERVE_ROWS} rows (at least slow_xla's aggregate frames/s): {verdict}")

    for impl in ("auto", "int8"):
        batcher = ContinuousBatcher(serving[impl], SamplingArgs(**SAMPLING),
                                    horizon=SERVE_HORIZON)
        try:
            for i in SERVE_SEEDED:
                alone = serve(torch, np, batcher, codec, [reqs[i]])[0][0]
                check(np.array_equal(alone, first[impl][i][0]),
                      f"serving {impl}: seeded request {i} gives other codes alone than "
                      f"among 19 others")
        finally:
            batcher.shutdown()
        log("serving", f"{impl}: seeded requests {list(SERVE_SEEDED)}: the same codes alone on "
            f"a fresh batcher as among {SERVE_REQUESTS - 1} co-tenants (the row kernel and "
            f"the batched frame)")
    for impl in ("auto", "slow_xla", "xla", "int8"):
        profile_serving(torch, np, serving[impl], impl)
    profile_central(torch, np, serving["auto"], codec)
    return {**counted["auto"], **counted["int8"]}


# --------------------------------------------------------------------------
# Phase 6b: the serving surface over HTTP
# --------------------------------------------------------------------------

SERVER_BUCKETS = (64, 128, 256)  # a 40-word request; the cloned voice's prompt
SERVER_OPUS = 10  # requests 0-9 stream Ogg/Opus, 10-19 get WAV
SERVER_SEEDED = (11, 13)
SERVER_ARGMAX = (15, 17)
SERVER_CHUNK = 16  # stream_chunk_frames of the Opus requests
SERVER_SHORT = 32  # max_new_tokens of the static-batch and hidden-states requests
SERVER_WORDS = ("amber bright calm dawn ember field grove harbor island juniper kettle "
                "lantern meadow north orchard pebble quiet river silver timber upland "
                "valley willow yonder zephyr").split()


def server_texts(np, n: int) -> list:
    """n texts of 40 words and a full stop: one text chunk each."""
    rng = np.random.default_rng(11)
    return [" ".join(rng.choice(SERVER_WORDS, size=PROMPT_LEN)) + "." for _ in range(n)]


class HttpServers:
    """The port's aiohttp apps on localhost ports, in a thread running
    their event loop (a client's disconnect cancels its handler), and a
    stdlib http.client per request."""

    def __init__(self, states) -> None:
        import asyncio
        import threading

        from aiohttp import web

        from fish_speech_tpu_torch.server.app import create_app

        self.loop = asyncio.new_event_loop()
        self.runners, self.ports = [], []
        for state in states:
            try:
                runner = web.AppRunner(create_app(state), handler_cancellation=True)
            except TypeError:  # aiohttp before 3.9 cancels on disconnect anyway
                runner = web.AppRunner(create_app(state))
            self.loop.run_until_complete(runner.setup())
            site = web.TCPSite(runner, "127.0.0.1", 0)
            self.loop.run_until_complete(site.start())
            self.runners.append(runner)
            self.ports.append(site._server.sockets[0].getsockname()[1])
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def request(self, app: int, path: str, body: bytes, headers: dict, first_audio=None,
                drop: bool = False):
        """(status, content type, body, seconds to the first Opus audio
        page or None). first_audio: called at the first audio page;
        drop: close the connection there."""
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", self.ports[app], timeout=WAIT_S)
        t0 = time.perf_counter()
        try:
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            kind = resp.getheader("Content-Type", "").split(";")[0]
            data, t_audio = b"", None
            while True:
                piece = resp.read1(65536)
                if not piece:
                    break
                data += piece
                if kind == "audio/ogg" and t_audio is None and data.count(b"OggS") >= 3:
                    t_audio = time.perf_counter() - t0  # past OpusHead and OpusTags
                    if first_audio is not None:
                        first_audio()
                    if drop:
                        break
            return resp.status, kind, data, t_audio
        finally:
            conn.close()

    def close(self) -> None:
        import asyncio

        async def stop():
            for runner in self.runners:
                await runner.cleanup()

        asyncio.run_coroutine_threadsafe(stop(), self.loop).result(timeout=60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)


class CoreServers:
    """The aiohttp-free core (server/core.py) called on the client's
    thread, for a machine where aiohttp is missing: the same routes."""

    def __init__(self, states) -> None:
        self.states = states

    def request(self, app: int, path: str, body: bytes, headers: dict, first_audio=None,
                drop: bool = False):
        from fish_speech_tpu_torch.audio.decode import decode_audio_bytes
        from fish_speech_tpu_torch.server import core

        state, t0 = self.states[app], time.perf_counter()
        try:
            if path.startswith("/v1/audio/encoding"):
                query = dict(kv.split("=", 1) for kv in path.split("?", 1)[1].split("&"))
                audio, sr = decode_audio_bytes(body)
                codes = state.pipeline.encode_reference_audio(audio, sr)
                core.register_voice(state, query.get("id"), query.get("prompt"), codes)
                return 200, "application/x-npy", core.npy_bytes(codes), None
            req_body = json.loads(body)
            if path == "/v1/audio/hidden_states":
                return 200, "application/zip", core.hidden_states_zip(state, req_body), None
            req = core.SpeechRequest.parse(req_body, state.pipeline.default_sampling)
            if req.response_format != "opus":
                return 200, "audio/wav", core.wav_bytes(state, core.wav_pcm(state, req)), None
            handles, data, t_audio = [], b"", None
            gen = core.opus_body(state, req, on_submit=handles.append)
            try:
                for piece in gen:
                    data += piece
                    if t_audio is None and data.count(b"OggS") >= 3:
                        t_audio = time.perf_counter() - t0
                        if first_audio is not None:
                            first_audio()
                        if drop:
                            for h in handles:
                                h.cancel()
                            break
            finally:
                gen.close()
            return 200, "audio/ogg", data, t_audio
        except core.HTTPError as err:
            return err.status, "text/plain", err.text.encode(), None

    def close(self) -> None:
        pass


def sniff_batcher(np, batcher, key_of):
    """Record each batcher request (by the key of its first prompt) and
    the codes of its chunk results as the pipeline reads them (through
    iter_events or iter_chunks); returns
    {key: [request, codes (C+1, T) or None]}."""
    from fish_speech_tpu_torch.generate.continuous import _ChunkResult

    seen = {}
    submit = batcher.submit

    def recording(prompts, *a, **k):
        req = submit(prompts, *a, **k)
        entry = seen.setdefault(key_of(prompts[0]), [req, None])
        entry[0] = req
        def recorded(events):
            def iterate(timeout=None):
                for ev in events(timeout):
                    if isinstance(ev, _ChunkResult):
                        entry[1] = np.concatenate([ev.semantic[None], ev.tokens])
                    yield ev
            return iterate

        req.iter_events = recorded(req.iter_events)
        req.iter_chunks = recorded(req.iter_chunks)
        return req

    batcher.submit = recording
    return seen


def run_server(torch, np, params, cfg, tok, codec, codec_cfg, bound16, smi,
               decode_impl: str = "auto"):
    """The serving surface on the card: a TTSPipeline (constructor, the
    full-width Fish-1.5 weights, the loud bf16 codec, the stand-in
    tokenizer, reroll off) with `create_batcher(16, 16)`, behind the
    port's HTTP app (or its aiohttp-free core where aiohttp is missing):
    20 requests at once (10 Ogg/Opus streams with stream_chunk_frames 16,
    10 WAV, two seeded and two at temp 0), an Opus client that goes away
    after its first audio page, a voice encoded through
    /v1/audio/encoding and a request in it, a batch_size 2 request, a
    serial request and a hidden-states request on a second app without a
    batcher. Checks the responses, the seeded and temp-0 requests against
    synthesize_streaming_continuous called directly, the cancelled row's
    release, and each route's kernels. decode_impl: the pipeline engine's
    (and so its batcher's). Returns ({kernel: launches in this phase},
    the burst's {"requests_per_s", "frames_per_s", "rtf_p50", "ttfa_p50"})."""
    import importlib.util
    import threading

    from fish_speech_tpu_torch.audio import _natlib
    from fish_speech_tpu_torch.audio.decode import decode_audio_bytes
    from fish_speech_tpu_torch.audio.opus import OggOpusEncoder
    from fish_speech_tpu_torch.audio.wav import pcm_to_wav_bytes, read_wav
    from fish_speech_tpu_torch.config import WhichLM
    from fish_speech_tpu_torch.generate.engine import LMEngine
    from fish_speech_tpu_torch.ops import decode_attention as da
    from fish_speech_tpu_torch.ops import fast_frame as ff
    from fish_speech_tpu_torch.ops import fast_frame_batched as fb
    from fish_speech_tpu_torch.ops import prefill_attention as pa
    from fish_speech_tpu_torch.ops import slow_step as ss
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs
    from fish_speech_tpu_torch.pipeline import TTSPipeline
    from fish_speech_tpu_torch.server.core import AppState

    t_phase = time.perf_counter()
    engine = LMEngine(params, cfg, tok, WhichLM.FISH_1_5, cache_len=SERVE_CACHE,
                      max_frames=N_FRAMES, prompt_buckets=SERVER_BUCKETS,
                      decode_impl=decode_impl)
    pipeline = TTSPipeline(engine, codec, StandInTokenizer(cfg.codebook_size), WhichLM.FISH_1_5,
                           max_new_tokens=N_FRAMES, default_sampling=SamplingArgs(**SAMPLING))
    pipeline.reroll_on_runaway = False
    batcher = pipeline.create_batcher(SERVE_ROWS, SERVE_HORIZON)
    check(batcher._central is not None and batcher.engine.use_fused_slow
          and batcher.engine.use_fused_fast and engine.use_fused_slow and engine.use_fused_fast,
          "server: the pipeline's engines are not on the fused paths, or no central vocoder")
    batcher.warmup()
    pipeline.warmup_codec(SERVER_CHUNK)
    states = [AppState(pipeline, batcher=batcher), AppState(pipeline)]
    native = OggOpusEncoder.available()
    reason = " ".join((_natlib.build_error() or "").split())
    native_line = "built" if native else f"NOT built ({reason[-400:]})"
    if importlib.util.find_spec("aiohttp") is not None:
        servers, how = HttpServers(states), "the port's aiohttp app on localhost (http.client)"
    else:
        servers, how = CoreServers(states), "the aiohttp-free core (aiohttp is not installed)"
    texts = server_texts(np, SERVE_REQUESTS + 4)
    key_of = lambda p: np.asarray(p).tobytes()  # noqa: E731
    seen = sniff_batcher(np, batcher, key_of)
    enc = lambda text, voice=None: key_of(pipeline._encode(text, voice, None)[1][0])  # noqa: E731
    check(all(pipeline._encode(t, None, None)[1][0].shape[1] <= 64 for t in texts),
          "server: a 40-word request's prompt is longer than the 64-token bucket")
    mods = {"decode_attention": da, "prefill_attention": pa, "fused_slow_step": ss,
            "fused_fast_frame": ff, "fused_fast_frame_batched": fb}

    def counted(fn):
        for m in mods.values():
            m.launches = 0
        ss.rows_launches = 0
        out = fn()
        got = {name: m.launches for name, m in mods.items()}
        got["slow_step_rows"] = ss.rows_launches
        return out, got

    def body(i):
        b = {"input": texts[i], "voice": "unconditioned"}
        if i < SERVER_OPUS:
            b.update(response_format="opus", stream_chunk_frames=SERVER_CHUNK)
        if i in SERVER_SEEDED:
            b["seed"] = 1000 + i
        if i in SERVER_ARGMAX:
            b["temperature"] = 0.0
        return json.dumps(b).encode()

    spf, rate = codec.samples_per_frame, codec.sample_rate
    json_hdr = {"Content-Type": "application/json"}
    try:
        # 1. the serving cell's 20 requests at once, through the batcher.
        # Without the native encoder an Opus request is answered 501, and
        # the 10 streaming clients read the same low-latency PCM stream
        # from the core's generator (the Opus route's source), resampling
        # each chunk to 24 kHz as the route does
        if not native:
            status, kind, data, _ = servers.request(0, "/v1/audio/speech", body(0), json_hdr)
            check(status == 501 and b"native encoder" in data, f"server: an Opus request "
                  f"without the native encoder got {status} {data[:200]!r}, not 501")
        out = [None] * SERVE_REQUESTS
        resample_s = []

        def core_stream(i):
            from fish_speech_tpu_torch.audio.resample import StreamingResampler
            from fish_speech_tpu_torch.server import core

            req = core.SpeechRequest.parse(json.loads(body(i)), pipeline.default_sampling)
            rs, parts, t_first, t0 = StreamingResampler(rate, 24000), [], None, time.perf_counter()
            for pcm in core.pcm_chunks(states[0], req):
                t_first = time.perf_counter() - t0 if t_first is None else t_first
                t1 = time.perf_counter()
                rs.process(pcm)
                resample_s.append(time.perf_counter() - t1)
                parts.append(pcm)
            return 200, "audio/pcm", np.concatenate(parts), t_first

        def client(i):
            t0 = time.perf_counter()
            if i < SERVER_OPUS and not native:
                res = core_stream(i)
            else:
                res = servers.request(0, "/v1/audio/speech", body(i), json_hdr)
            out[i] = (t0, time.perf_counter(), *res)

        def burst():
            threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_REQUESTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WAIT_S)
            check(all(o is not None for o in out), "server: a client got no response")

        _, burst_launches = counted(burst)
        frames, rtf, ttfa = [], [], []
        for i, (t0, t1, status, kind, data, t_audio) in enumerate(out):
            entry = seen.get(enc(texts[i]))
            check(status == 200 and entry is not None and entry[1] is not None,
                  f"server request {i}: status {status} ({data[:200]!r}), codes seen "
                  f"{entry is not None and entry[1] is not None}")
            t = entry[1].shape[1]
            check(1 <= t <= N_FRAMES and bool(((entry[1][1:] >= 0)
                                                & (entry[1][1:] < cfg.codebook_size)).all()),
                  f"server request {i}: codes {entry[1].shape} out of range")
            if kind == "audio/ogg":
                check(t_audio is not None, f"server request {i}: no Opus audio page")
                pcm, sr = decode_audio_bytes(data)
                want = t * spf * sr / rate
                check(abs(pcm.shape[0] - want) <= spf * sr / rate and np.isfinite(pcm).all(),
                      f"server request {i}: Opus decodes to {pcm.shape[0]} samples at {sr} Hz, "
                      f"expected {want:.0f} within a frame")
                ttfa.append(t_audio)
            elif kind == "audio/pcm":
                check(data.shape == (t * spf,) and np.isfinite(data).all() and t_audio is not None,
                      f"server request {i}: streamed PCM {data.shape}, expected {(t * spf,)}")
                ttfa.append(t_audio)
            else:
                check(kind == "audio/wav", f"server request {i}: {kind}")
                pcm, sr = read_wav(data)
                check(sr == rate and pcm.shape == (t * spf,) and np.isfinite(pcm).all(),
                      f"server request {i}: WAV {pcm.shape} at {sr}, expected {(t * spf,)}")
            frames.append(t)
            rtf.append((t1 - t0) / (t / codec_cfg.frame_rate))
        span = max(o[1] for o in out) - min(o[0] for o in out)
        m = states[0].metrics
        if m.opus_chunks:
            opus_line = (f"Opus host work a chunk on the event loop: resample "
                         f"{1e3 * m.opus_resample_s / m.opus_chunks:.3f} ms, encode "
                         f"{1e3 * m.opus_encode_s / m.opus_chunks:.3f} ms ({m.opus_chunks} chunks)")
        else:
            opus_line = (f"no native encoder: Opus answered 501; the streaming clients read the "
                         f"core's PCM stream, resample "
                         f"{1e3 * sum(resample_s) / max(len(resample_s), 1):.3f} ms a chunk "
                         f"({len(resample_s)} chunks), encode not measured")

        # 2. the seeded and temp-0 WAV requests, called directly
        direct = {}

        def direct_call(i):
            sampling = SamplingArgs(**dict(SAMPLING, temp=0.0)) if i in SERVER_ARGMAX else None
            direct[i] = np.concatenate(list(pipeline.synthesize_streaming_continuous(
                batcher, texts[i], sampling=sampling, seed=1000 + i if i in SERVER_SEEDED
                else None)))

        http_codes = {i: seen[enc(texts[i])][1] for i in SERVER_SEEDED + SERVER_ARGMAX}
        threads = [threading.Thread(target=direct_call, args=(i,))
                   for i in SERVER_SEEDED + SERVER_ARGMAX]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        worst = 0.0
        for i in SERVER_SEEDED + SERVER_ARGMAX:
            check(np.array_equal(seen[enc(texts[i])][1], http_codes[i]),
                  f"server request {i}: other codes when called directly than over HTTP")
            got = read_wav(out[i][4])[0]
            ref = read_wav(pcm_to_wav_bytes(direct[i], rate))[0]
            err = float(np.abs(got - ref).max())
            worst = max(worst, err)
            check(got.shape == ref.shape and err <= 2 * bound16 + 2 * PCM_I16_ATOL,
                  f"server request {i}: PCM {err:.3e} from the direct call's (limit "
                  f"{2 * bound16 + 2 * PCM_I16_ATOL:.3e})")

        # 3. a client that goes away after its first audio: an Opus client
        # closing its connection; without the native encoder, the core's
        # PCM generator closed after its first chunk
        cancel_text = texts[SERVE_REQUESTS]
        if native:
            servers.request(0, "/v1/audio/speech", json.dumps(
                {"input": cancel_text, "voice": "unconditioned", "response_format": "opus",
                 "stream_chunk_frames": SERVER_CHUNK}).encode(), json_hdr, drop=True)
        else:
            from fish_speech_tpu_torch.server import core

            gen = core.pcm_chunks(states[0], core.SpeechRequest.parse(
                {"input": cancel_text, "voice": "unconditioned",
                 "stream_chunk_frames": SERVER_CHUNK}, pipeline.default_sampling))
            next(gen)
            gen.close()
        req = seen[enc(cancel_text)][0]
        t0 = time.perf_counter()
        while req.freed_tick is None or any(s is not None for s in batcher.rows):
            check(time.perf_counter() - t0 < WAIT_S, "server: the cancelled row was not freed")
            time.sleep(0.001)
        check(req.cancelled and req.freed_tick - req.cancel_tick <= 2,
              f"server: the cancelled request's row was freed {req.freed_tick - req.cancel_tick} "
              "ticks after its cancel, more than two horizons")
        cancel_s = req.freed_time - req.cancel_time

        # 4. a voice through /v1/audio/encoding, then a request in it
        import tempfile
        from pathlib import Path
        from urllib.parse import quote

        with tempfile.TemporaryDirectory() as tmp:
            voice_wav(np, Path(tmp) / "voice.wav")
            wav_in = (Path(tmp) / "voice.wav").read_bytes()
        boundary = "fishboundary"
        form = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; filename=\"v.wav\""
                f"\r\nContent-Type: audio/wav\r\n\r\n").encode() + wav_in + \
            f"\r\n--{boundary}--\r\n".encode()
        status, kind, data, _ = servers.request(
            0, f"/v1/audio/encoding?id=clone&prompt={quote(CLI_PROMPT_TEXT)}", form,
            {"Content-Type": f"multipart/form-data; boundary={boundary}"})
        check(status == 200 and kind == "application/x-npy", f"server encoding: {status} {kind}")
        voice_codes = np.load(io.BytesIO(data))
        check(voice_codes.shape[0] == cfg.num_codebooks and voice_codes.shape[1] > 80
              and int(voice_codes.max()) < cfg.codebook_size and "clone" in states[0].voices,
              f"server encoding: codes {voice_codes.shape}, registered "
              f"{'clone' in states[0].voices}")
        vtext = texts[SERVE_REQUESTS + 1]
        status, kind, data, _ = servers.request(0, "/v1/audio/speech", json.dumps(
            {"input": vtext, "voice": "clone", "seed": 5}).encode(), json_hdr)
        vkey = enc(vtext, states[0].voices["clone"])
        check(status == 200 and vkey in seen and read_wav(data)[0].shape[0]
              == seen[vkey][1].shape[1] * spf, f"server: the cloned voice's request {status}")
        t0 = time.perf_counter()  # a central row is released just after its last PCM
        while not (all(s is None for s in batcher.rows) and batcher.queue.empty()):
            check(time.perf_counter() - t0 < 10, "server: a request is left in the batcher")
            time.sleep(0.001)

        # 5. static batch, then the serial and hidden-states routes
        def static():
            return servers.request(0, "/v1/audio/speech", json.dumps(
                {"input": texts[SERVE_REQUESTS + 2], "voice": "unconditioned", "batch_size": 2,
                 "max_new_tokens": SERVER_SHORT}).encode(), json_hdr)

        (status, kind, data, _), static_launches = counted(static)
        n = read_wav(data)[0].shape[0] if status == 200 else 0
        check(kind == "audio/wav" and 0 < n <= SERVER_SHORT * spf and n % spf == 0,
              f"server static batch: {status} {kind}, {n} samples")

        def serial():
            a = servers.request(1, "/v1/audio/speech", json.dumps(
                {"input": texts[SERVE_REQUESTS + 3], "voice": "unconditioned", "seed": 7}
            ).encode(), json_hdr)
            b = servers.request(1, "/v1/audio/hidden_states", json.dumps(
                {"input": texts[0], "voice": "unconditioned", "seed": 7,
                 "max_new_tokens": SERVER_SHORT}).encode(), json_hdr)
            return a, b

        (wav_res, zip_res), serial_launches = counted(serial)
        n = read_wav(wav_res[2])[0].shape[0] if wav_res[0] == 200 else 0
        check(0 < n <= N_FRAMES * spf and n % spf == 0,
              f"server serial request: {wav_res[0]}, {n} samples")
        import zipfile

        zf = zipfile.ZipFile(io.BytesIO(zip_res[2]))
        hidden = np.load(io.BytesIO(zf.read("hidden_states.npy")))
        meta = json.loads(zf.read("metadata.json"))
        check(zip_res[0] == 200 and hidden.shape[1] == cfg.dim
              and 1 <= hidden.shape[0] <= SERVER_SHORT and np.isfinite(hidden).all()
              and meta["num_frames"] == hidden.shape[0],
              f"server hidden states: {zip_res[0]} {hidden.shape} {meta}")
    finally:
        servers.close()
        batcher.shutdown()
    check(burst_launches["prefill_attention"] > 0 and burst_launches["slow_step_rows"] > 0
          and burst_launches["fused_fast_frame_batched"] > 0,
          f"server: the batcher routes launched {burst_launches}")
    check(static_launches["decode_attention"] > 0, f"server: static batch {static_launches}")
    check(serial_launches["fused_slow_step"] > 0 and serial_launches["fused_fast_frame"] > 0,
          f"server: serial and hidden-states routes {serial_launches}")
    n_ok = len(frames)
    log("server", f"served through {how}; native audio library (libfishaudio.so) "
        f"{native_line}; {SERVE_REQUESTS} requests at once ({SERVER_OPUS} Ogg/Opus with "
        f"stream_chunk_frames {SERVER_CHUNK}" + ("" if native else ", read from the core")
        + f", {SERVE_REQUESTS - SERVER_OPUS} WAV; seeded "
        f"{list(SERVER_SEEDED)}, temp 0 {list(SERVER_ARGMAX)}) through create_batcher("
        f"{SERVE_ROWS}, {SERVE_HORIZON}) with the central vocoder: {n_ok} answered 200 "
        f"in {span:.3f}s = {n_ok / span:.2f} requests/s, {sum(frames)} frames = "
        f"{sum(frames) / span:.1f} frames/s aggregate; client RTF p50 "
        f"{float(np.percentile(rtf, 50)):.4f} p95 {float(np.percentile(rtf, 95)):.4f}; "
        + f"TTFA of the streaming clients (to the first " + ("Opus audio page" if native else
                                                              "PCM chunk") + f") p50 "
        f"{float(np.percentile(ttfa, 50)):.4f}s p95 {float(np.percentile(ttfa, 95)):.4f}s; "
        f"{opus_line} on {smi}")
    log("server", f"seeded and temp-0 requests: codes over HTTP = a direct "
        f"synthesize_streaming_continuous call's, PCM within {worst:.3e} (limit "
        f"{2 * bound16 + 2 * PCM_I16_ATOL:.3e}); a client that left after its first audio: "
        f"row free {req.freed_tick - req.cancel_tick} tick(s) and {cancel_s:.4f}s after the "
        f"cancel; voice encoded ({voice_codes.shape[1]} frames) and registered, a request in "
        f"it; batch_size 2, serial and hidden-states routes; no request left in the batcher; "
        f"phase {time.perf_counter() - t_phase:.1f}s")
    log("server", f"launches: batcher routes {json.dumps(burst_launches)}; static batch "
        f"{json.dumps(static_launches)}; serial + hidden states {json.dumps(serial_launches)}")
    metrics = {"requests_per_s": n_ok / span, "frames_per_s": sum(frames) / span,
               "rtf_p50": float(np.percentile(rtf, 50)),
               "ttfa_p50": float(np.percentile(ttfa, 50))}
    return {k: burst_launches[k] + static_launches[k] + serial_launches[k]
            for k in burst_launches}, metrics


# --------------------------------------------------------------------------
# Phase 7: the int8 proxy
# --------------------------------------------------------------------------


# -- versions: Fish 1.2, Fish 1.4 and DualAR through the ported kernels ------

VERSIONS = ("1.2", "1.4", "dual_ar")
VERSION_FRAMES = 64
VERSION_REQUESTS = 8
VERSION_SEEDED = (2, 5)  # requests with a seed, each run again alone
VERSION_XLA_FRAMES = 8  # the unfused path, which launches decode attention
# DualAR's stand-in vocab holds the stand-in tokenizer's 2048
# <|semantic:i|> ids from 100012, rounded up to a multiple of 128
DUAL_AR_VOCAB = 102144
# Fish 1.2's vocab has 32000 ids: the stand-in tokenizer's specials there
LEGACY_TOKEN_BASE = 28000
# Mimi in float32 with TF32 off: the card's decode against the CPU's, and
# the card's stream against its batch decode
MIMI_TOL = 1e-4
MIMI_FRAMES = 32
MIMI_CHUNKING = (1, 7, 16, 3, 5)


def version_setup(version: str):
    """(cfg, lm, tokenizer, TokenConfig, what the widths are) of a
    version. Fish 1.2: its published config. Fish 1.4 and DualAR: their
    config.json files are not in the repo, so stand-in widths: the 1.2
    backbone with 8 codebooks of 1024 (the Firefly-1.4 quantizer's 8
    groups), and the 1.5 backbone with depthwise_wte and
    depthwise_output, 8 codebooks of 2048 (Mimi's codebook size) and a
    vocab that holds the stand-in tokenizer's 2048 semantic ids."""
    from fish_speech_tpu_torch.config import DualARConfig, TokenConfig, WhichLM

    if version == "1.2":
        cfg, lm, what = DualARConfig.fish_speech_1_2(), WhichLM.FISH_1_2, "published widths"
    elif version == "1.4":
        cfg = dataclasses.replace(DualARConfig.fish_speech_1_2(), num_codebooks=8)
        lm, what = WhichLM.FISH_1_4, "stand-in widths: the 1.2 backbone, 8 codebooks x 1024"
    else:
        cfg = dataclasses.replace(DualARConfig.fish_speech_1_5(), vocab_size=DUAL_AR_VOCAB,
                                  codebook_size=2048, depthwise_wte=True,
                                  depthwise_output=True)
        lm, what = (WhichLM.DUAL_AR, f"stand-in widths: the 1.5 backbone, depthwise, 8 "
                    f"codebooks x 2048, vocab {DUAL_AR_VOCAB}")
    legacy = lm in (WhichLM.FISH_1_2, WhichLM.FISH_1_4)
    tokenizer = StandInTokenizer(cfg.codebook_size, LEGACY_TOKEN_BASE if legacy else 100008)
    return cfg, lm, tokenizer, TokenConfig.from_tokenizer(lm, tokenizer, cfg), what


def version_params(torch, cfg, tok, device):
    """Random bf16 weights (seed 0) whose generations run their length:
    the <|im_end|> column zeroed; for Fish <= 1.4, whose PAD/EOS draw is
    random at every temperature, embedding dimension 0 set to PAD_BIAS
    (it stays the largest through the residual stream and the final
    norm) and read by the PAD column alone, so that PAD wins the draw."""
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params

    params = init_dual_ar_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    params["output"][:, tok.im_end_id] = 0
    if tok.semantic_end_id is None:
        params["embeddings"][:, 0] = PAD_BIAS
        params["output"][:, tok.pad_id] = 0
        params["output"][0, tok.pad_id] = 1.0
    return params


# the kernels line's numbers of a kernel at a version's shapes
VERSION_KEYS = ("max_abs_err", "err_vs_float32", "ms", "plain_ms", "bound_ms", "bound_by",
                "bound_reread_ms", "share_of_bound", "launches_per_call", "shape")


def check_version_kernels(torch, label: str, engine, rows) -> dict:
    """Rows 3, 4, 5 and 3b (or their int8 bodies) on the engines a
    version's path runs, with their weights: the batch-1 engine and the
    serving engine of SERVE_ROWS rows, through the kernels phase's checks
    (the bounds computed at these shapes). Returns {kernel: VERSION_KEYS
    of its numbers}."""
    params32 = float32_copy(engine.params)
    main_pos = PROMPT_LEN + VERSION_FRAMES // 2
    got = [check_slow_step(torch, engine, params32, main_pos, label),
           check_fast_frame(torch, engine, params32, label),
           check_fast_frame_batched(torch, rows, params32, label),
           check_slow_step_rows(torch, rows, params32, label)]
    del params32
    return {k["name"]: {key: k[key] for key in VERSION_KEYS if key in k} for k in got}


def version_firefly(torch, np, cfg, version):
    """The version's Firefly codec, bf16 (seed 1), made loud (`loud_codec`)
    on seeded codes, its float32 copy, and the bf16 bound
    (ACCURACY_FACTOR x the bf16 decode's largest distance to the float32
    one on those codes)."""
    from fish_speech_tpu_torch.config import FireflyConfig, FishVersion
    from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec, init_firefly_params

    codec_cfg = FireflyConfig.for_version(FishVersion(version))
    codec = FireflyCodec(init_firefly_params(codec_cfg, seed=1, dtype=torch.bfloat16,
                                             device="cuda"), codec_cfg,
                         device="cuda")
    codes = np.random.default_rng(1).integers(0, 1000, size=(cfg.num_codebooks, 48))
    codec, scale = loud_codec(np, codec, codec_cfg, codes.astype(np.int32))
    codec32 = FireflyCodec(float32_copy(codec.params), codec_cfg, device="cuda")
    own = float(np.abs(codec.decode(codes) - codec32.decode(codes)).max())
    return codec, codec32, codec_cfg, ACCURACY_FACTOR * own, scale


def version_mimi(torch, np, smi):
    """Mimi at kyutai/mimi's width (MimiConfig.kyutai(), 32 codebooks in
    the file, 8 decoded), float32: random weights (seed 2) written in
    transformers' names and read back through the port's loader,
    bit-equal to the state dict's conversion; the decoder's last conv
    scaled by a power of two so the PCM of seeded codes peaks near
    STREAM_PEAK; the card's batch decode within MIMI_TOL of the CPU's
    (TF32 off), the card's stream in uneven pieces within MIMI_TOL of its
    batch decode; decode_step timed at 16 and 64 frames, batch 1 and 16.
    Returns the codec."""
    import tempfile
    from pathlib import Path

    from fish_speech_tpu_torch.device import tree_to
    from fish_speech_tpu_torch.io.checkpoint import save_safetensors
    from fish_speech_tpu_torch.models.codec import mimi

    cfg = mimi.MimiConfig.kyutai()
    t0 = time.perf_counter()
    sd = mimi.random_mimi_state_dict(cfg, seed=2, device="cuda")
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "mimi.safetensors"
        save_safetensors(path, sd)
        size, write_s = path.stat().st_size, time.perf_counter() - t0
        t1 = time.perf_counter()
        params = mimi.load_mimi_params(path, cfg, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
    check(trees_equal(torch, params, mimi.convert_mimi_state_dict(sd, cfg, device="cuda")),
          "versions dual_ar: Mimi weights read back differ from the state dict's conversion")
    del sd
    codes = np.random.default_rng(3).integers(0, cfg.codebook_size, size=(8, MIMI_FRAMES))
    peak = float(np.abs(mimi.MimiCodec(params, cfg, 8, device="cuda").decode(codes)).max())
    check(np.isfinite(peak) and peak > 0, f"versions dual_ar: Mimi's PCM peak is {peak}")
    scale = 2.0 ** round(float(np.log2(STREAM_PEAK / peak)))
    last = params["decoder"]["layers"][-1]
    params["decoder"]["layers"][-1] = {"w": last["w"] * scale, "b": last["b"] * scale}
    codec = mimi.MimiCodec(params, cfg, num_quantizers=8, device="cuda")
    got = codec.decode(codes)
    ref = mimi.MimiCodec(tree_to(params, "cpu"), cfg, 8, device="cpu").decode(codes)
    err = float(np.abs(got - ref).max())
    peak = float(np.abs(ref).max())
    check(got.shape == (1, MIMI_FRAMES * codec.samples_per_frame) and np.isfinite(got).all()
          and err <= MIMI_TOL,
          f"versions dual_ar: Mimi's float32 decode on the card {err:.3e} from the CPU's "
          f"(limit {MIMI_TOL}), shape {got.shape}")
    check(peak * 32767 >= PCM_MIN_STEPS, f"versions dual_ar: Mimi's PCM peaks at "
          f"{peak * 32767:.1f} int16 steps")
    err_s = float(np.abs(stream_decode(np, codec, codes, MIMI_CHUNKING) - got[0]).max())
    check(err_s <= MIMI_TOL, f"versions dual_ar: Mimi's stream in pieces {MIMI_CHUNKING} "
          f"{err_s:.3e} from its batch decode (limit {MIMI_TOL})")
    log("versions", f"dual_ar: Mimi (kyutai/mimi's widths, {cfg.num_quantizers} codebooks in "
        f"the file, 8 decoded, float32) written in transformers' names ({size / 1e6:.1f} MB, "
        f"{write_s:.2f}s) and read back through load_mimi_params ({load_s:.2f}s) bit-equal; "
        f"decoder's last conv x {scale:g} (a power of two): |pcm|max {peak:.4f} = "
        f"{peak * 32767:.0f} int16 steps; {MIMI_FRAMES} frames, card vs CPU max_abs_err "
        f"{err:.3e}, stream in pieces {list(MIMI_CHUNKING)} vs batch {err_s:.3e} (limit "
        f"{MIMI_TOL}, TF32 off)")
    steps = {}
    for b in (1, 16):
        state = codec.stream_template(b, 64)
        for t in (16, 64):
            c = np.tile(codes[None, :, :1], (b, 1, t))
            steps[f"{b}x{t}"] = ms = eager_ms(torch, lambda: codec.decode_step(c, state), 10)
            audio_ms = 1e3 * b * t / cfg.frame_rate
            log("versions", f"dual_ar: Mimi decode_step float32 (host codes in, host PCM out), "
                f"batch {b} x {t} frames: {ms:.3f} ms ({audio_ms / ms:.1f}x real time for "
                f"{audio_ms:.0f} ms of audio) on {smi}")
    return codec, steps


def version_serving(torch, np, pipeline, batcher, codec, bound, label, frame_rate):
    """VERSION_REQUESTS requests of 40 words at once through the
    pipeline's 16-row batcher (synthesize_streaming_continuous: the
    central vocoder where the codec streams, else each client decodes its
    chunk), two seeded and each run again alone: codes equal alone and in
    the burst, each request's PCM its codes' length, finite, and for the
    seeded ones within `bound` of codec.decode of their codes. Returns
    (frames/s, RTF p50, launches)."""
    import threading

    from fish_speech_tpu_torch.ops import decode_attention as da
    from fish_speech_tpu_torch.ops import fast_frame_batched as fb
    from fish_speech_tpu_torch.ops import prefill_attention as pa
    from fish_speech_tpu_torch.ops import slow_step as ss

    texts = server_texts(np, VERSION_REQUESTS)
    key_of = lambda p: np.asarray(p).tobytes()  # noqa: E731
    seen = sniff_batcher(np, batcher, key_of)
    shift = pipeline._shift_output_tokens
    spf = codec.samples_per_frame

    def client(i, out):
        t0 = time.perf_counter()
        seed = 1000 + i if i in VERSION_SEEDED else None
        pcm = np.concatenate(list(pipeline.synthesize_streaming_continuous(
            batcher, texts[i], seed=seed)))
        out[i] = (pcm, time.perf_counter() - t0)

    for m in (da, pa, fb):
        m.launches = 0
    ss.rows_launches = 0
    out = {}
    threads = [threading.Thread(target=client, args=(i, out)) for i in range(VERSION_REQUESTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    wall = time.perf_counter() - t0
    launches = {"decode_attention": da.launches, "prefill_attention": pa.launches,
                "slow_step_rows": ss.rows_launches, "fused_fast_frame_batched": fb.launches}
    check(len(out) == VERSION_REQUESTS, f"versions {label}: {len(out)} of {VERSION_REQUESTS} "
          f"requests ended")
    check(launches["decode_attention"] == 0 and all(
        launches[k] > 0 for k in ("prefill_attention", "slow_step_rows",
                                  "fused_fast_frame_batched")),
          f"versions {label}: serving launches {launches}")
    codes = {i: seen[key_of(pipeline._encode(texts[i], None, None)[1][0])][1].copy()
             for i in range(VERSION_REQUESTS)}
    frames, rtf = 0, []
    for i, (pcm, secs) in out.items():
        n = codes[i].shape[1]
        check(pcm.shape == (n * spf,) and bool(np.isfinite(pcm).all()) and n > 0,
              f"versions {label}: request {i}'s PCM {pcm.shape}, {n} frames of codes")
        frames += n
        rtf.append(secs / (n / frame_rate))
    for i in VERSION_SEEDED:
        pcm = out[i][0]
        err = float(np.abs(pcm - codec.decode(shift(codes[i][1:]))[0]).max())
        check(err <= bound, f"versions {label}: seeded request {i}'s PCM {err:.3e} from "
              f"codec.decode of its codes (bound {bound:.3e})")
        alone = {}
        client(i, alone)
        again = seen[key_of(pipeline._encode(texts[i], None, None)[1][0])][1]
        check(np.array_equal(again, codes[i]), f"versions {label}: seeded request {i}'s codes "
              f"alone differ from its codes among {VERSION_REQUESTS}")
    fps, p50 = frames / wall, float(np.median(rtf))
    log("versions", f"{label}: {VERSION_REQUESTS} requests through create_batcher"
        f"({SERVE_ROWS}, {SERVE_HORIZON}) "
        f"({'central vocoder' if batcher._central is not None else 'clients vocode'}): "
        f"{frames} frames in {wall:.3f}s = {fps:.1f} frames/s, RTF p50 {p50:.4f}; seeded "
        f"{list(VERSION_SEEDED)} equal alone; launches {json.dumps(launches)}")
    return fps, p50, launches


def run_version(torch, np, version: str, smi) -> dict:
    """One version through the ported kernels: the kernels against their
    plain versions at its shapes; batch 1 (40 tokens, VERSION_FRAMES on
    `auto`, vocoded to a WAV), its unfused path for decode attention;
    16-row serving through TTSPipeline.create_batcher; for DualAR, Mimi on
    the card and the overlapped driver with Mimi. Returns {"launches":
    {kernel: n}, "kernels": {kernel: stats}, ...}."""
    from fish_speech_tpu_torch.generate.engine import LMEngine
    from fish_speech_tpu_torch.generate.overlap import generate_vocode_overlapped, output_shift
    from fish_speech_tpu_torch.ops import decode_attention as da
    from fish_speech_tpu_torch.ops import fast_frame as ff
    from fish_speech_tpu_torch.ops import prefill_attention as pa
    from fish_speech_tpu_torch.ops import slow_step as ss
    from fish_speech_tpu_torch.ops.sampling import BATCHED_REP_PEN_WINDOW, SamplingArgs
    from fish_speech_tpu_torch.pipeline import TTSPipeline

    t0 = time.perf_counter()
    cfg, lm, tokenizer, tok, what = version_setup(version)
    label = f"Fish {version}" if version != "dual_ar" else "DualAR"
    params = version_params(torch, cfg, tok, "cuda")
    engine = LMEngine(params, cfg, tok, lm, cache_len=SERVE_CACHE, max_frames=VERSION_FRAMES,
                      prompt_buckets=SERVER_BUCKETS, device="cuda")
    sampling = SamplingArgs(**SAMPLING)
    if version == "dual_ar":
        codec, steps = version_mimi(torch, np, smi)
        codec32, bound, frame_rate, codec_what = codec, MIMI_TOL, codec.cfg.frame_rate, "Mimi"
    else:
        codec, codec32, codec_cfg, bound16, scale = version_firefly(torch, np, cfg, version)
        frame_rate, steps = codec_cfg.frame_rate, None
        bound = bound16 if not codec.can_stream else 2 * bound16 + 1.0 / 32767
        codec_what = (f"Firefly-{version} bf16 (seed 1, conv_post x {scale:g}"
                      f"{', not streaming' if not codec.can_stream else ''})")
    pipeline = TTSPipeline(engine, codec, tokenizer, lm, max_new_tokens=VERSION_FRAMES,
                           default_sampling=sampling)
    pipeline.reroll_on_runaway = False
    batcher = pipeline.create_batcher(SERVE_ROWS, SERVE_HORIZON)
    rows = batcher.engine
    check(engine.use_fused_slow and engine.use_fused_fast and rows.use_fused_slow
          and rows.use_fused_fast and (batcher._central is not None) == codec.can_stream,
          f"versions {label}: `auto` is not on the fused kernels at batch 1 and 16 rows, or "
          f"the central vocoder is {'missing' if codec.can_stream else 'there'}")
    log("versions", f"{label} ({what}; {cfg.n_layer} + {cfg.n_fast_layer} layers, dim "
        f"{cfg.dim}, {cfg.n_head}/{cfg.n_local_heads} heads, vocab {cfg.vocab_size}, "
        f"{cfg.num_codebooks} x {cfg.codebook_size}; random bf16 weights, seed 0) with "
        f"{codec_what}; `auto` at batch 1 and at {SERVE_ROWS} rows: the fused slow step and "
        f"fast frame, the row kernel and the batched frame; semantic head "
        f"{engine.params['output'].shape[1]} columns; {time.perf_counter() - t0:.1f}s")
    # the kernels against their plain versions on the engines of this
    # path; for DualAR's V = 2048 also the int8 bodies, on int8 engines of
    # the same weights (held to a float32 evaluation of the dequantized ones)
    with torch.inference_mode():
        kernels = check_version_kernels(torch, label, engine, rows)
        if version == "dual_ar":
            kw = dict(cache_len=SERVE_CACHE, prompt_buckets=(64,), quantize_int8=True)
            kernels.update(check_version_kernels(
                torch, label + " int8", LMEngine(params, cfg, tok, lm, **kw),
                LMEngine(params, cfg, tok, lm, batch_size=SERVE_ROWS, dynamic_sampling=True,
                         rep_pen_window=BATCHED_REP_PEN_WINDOW, **kw)))

    # batch 1 on `auto`: launches, frames/s, a WAV
    launches, _, _, _, stats = run_path(torch, np, engine, codec, tok, codec32.cfg,
                                        VERSION_FRAMES, f"versions {label} auto")
    steps = decode_frames(engine, VERSION_FRAMES - 1)
    want = {"fused_slow_step": steps, "fused_fast_frame": steps,
            "prefill_attention": cfg.n_layer, "decode_attention": 0}
    check(launches == want, f"versions {label}: batch-1 launches {launches}, expected {want}")
    prompt = main_prompt(np, cfg)
    if cfg.depthwise_wte:  # DualAR's codebook rep-pen is off: the penalty changes nothing
        a = engine.generate(prompt, max_new_tokens=16, sampling=sampling, seed=7)[0]
        b = engine.generate(prompt, max_new_tokens=16, seed=7, sampling=SamplingArgs(
            **{**SAMPLING, "repetition_penalty": 1.0}))[0]
        check(np.array_equal(a.tokens, b.tokens) and np.array_equal(a.semantic, b.semantic),
              f"versions {label}: rep-pen 1.4 and 1.0 give other codes under depthwise_wte")
    unfused = LMEngine(params, cfg, tok, lm, cache_len=SERVE_CACHE,
                       max_frames=VERSION_XLA_FRAMES, prompt_buckets=(64,), slow_impl="xla",
                       fast_frame_impl="xla", device="cuda")
    # its decode loops captured outside the count
    unfused.generate(prompt, max_new_tokens=VERSION_XLA_FRAMES, sampling=sampling, seed=0)
    da.launches = 0
    res, _ = unfused.generate(prompt, max_new_tokens=VERSION_XLA_FRAMES, sampling=sampling,
                              seed=1)
    launches["decode_attention"] = da.launches
    check(da.launches == cfg.n_layer * decode_frames(unfused, res.frames - 1)
          and res.frames == VERSION_XLA_FRAMES,
          f"versions {label}: the unfused path launched decode attention {da.launches} times "
          f"over {res.frames} frames")
    del unfused

    # DualAR: the overlapped batch-1 driver with Mimi
    overlap = None
    if version == "dual_ar":
        shift = output_shift(lm)
        kw = dict(sampling=sampling, max_new_tokens=VERSION_FRAMES, chunk=OVERLAP_CHUNK,
                  shift_fn=shift)
        generate_vocode_overlapped(engine, codec, prompt, seed=4, **kw)  # warm-up
        for m in (pa, ss, ff):
            m.launches = 0
        t1 = time.perf_counter()
        pcm, res, _ = generate_vocode_overlapped(engine, codec, prompt, seed=5, **kw)
        wall = time.perf_counter() - t1
        counts = {"prefill_attention": pa.launches, "fused_slow_step": ss.launches,
                  "fused_fast_frame": ff.launches}
        ref, _ = engine.generate(prompt, max_new_tokens=VERSION_FRAMES, sampling=sampling,
                                 seed=5)
        check(np.array_equal(res.tokens, ref.tokens) and np.array_equal(res.semantic,
                                                                        ref.semantic),
              "versions DualAR: overlapped tokens differ from generate's on the same seed")
        dec = codec.decode(shift(ref.tokens))[0]
        err = float(np.abs(pcm - dec).max())
        peak = float(np.abs(dec).max())
        check(all(counts.values()) and pcm.shape == dec.shape and err <= MIMI_TOL
              and peak * 32767 >= PCM_MIN_STEPS,
              f"versions DualAR: overlapped PCM {err:.3e} from Mimi's decode (limit "
              f"{MIMI_TOL}), peak {peak * 32767:.0f} int16 steps, launches {counts}")
        overlap = wall / (res.frames / frame_rate)
        log("versions", f"DualAR: generate_vocode_overlapped with Mimi, chunk {OVERLAP_CHUNK}, "
            f"{res.frames} frames: tokens equal generate's (seed 5), PCM (|pcm|max {peak:.4f}) "
            f"{err:.3e} from Mimi's decode of them; RTF {overlap:.4f}; launches "
            f"{json.dumps(counts)}")

    # 16-row serving through the pipeline's batcher
    batcher.warmup()
    pipeline.warmup_codec(SERVE_HORIZON)
    try:
        fps, p50, served = version_serving(torch, np, pipeline, batcher, codec, bound, label,
                                           frame_rate)
    finally:
        batcher.shutdown()
    launches["prefill_attention"] += served["prefill_attention"]
    launches["slow_step_rows"] = served["slow_step_rows"]
    launches["fused_fast_frame_batched"] = served["fused_fast_frame_batched"]
    log("versions", f"{label}: phase {time.perf_counter() - t0:.1f}s; launches "
        f"{json.dumps(launches)}")
    return {"launches": launches, "kernels": kernels,
            "batch1_frames_per_s": stats[0],
            "batch1_rtf": stats[1], "serving_frames_per_s": fps, "serving_rtf_p50": p50,
            "overlap_rtf": overlap, "mimi_decode_step_ms": steps}


def run_versions(torch, np, smi) -> dict:
    """Each of VERSIONS in turn, its engines and codec freed before the
    next is built. Returns {version: run_version's result}."""
    import gc

    out = {}
    for version in VERSIONS:
        out[version] = run_version(torch, np, version, smi)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_int8_proxy(torch, np, engine, engine8, params, codec, codec_cfg) -> None:
    """bench.py::bench_int8_proxy at full size on the same random weights:
    the bf16 and the int8 engine generate 128 frames at argmax; both
    parameter sets score the bf16 trajectory teacher-forced; the two
    sets of predicted codes are vocoded by the bf16 codec, and their
    mel-L1 is set against the bf16-vs-float32 vocoder floor on the same
    codes. The verdict of int8_policy.evaluate is reported; no decision
    file is written."""
    from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec, init_firefly_params
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs
    from fish_speech_tpu_torch.utils import int8_policy
    from fish_speech_tpu_torch.utils.quality import (
        mel_l1_distance, pcm_metrics, teacher_forced_agreement, teacher_forced_predictions)

    t0 = time.perf_counter()
    cfg, tok = engine.cfg, engine.token_cfg
    sampling = SamplingArgs(temp=0.0, top_p=1.0, top_k=1, repetition_penalty=1.0)
    prompt = main_prompt(np, cfg)
    gen = {name: e.generate(prompt, max_new_tokens=N_FRAMES, sampling=sampling, seed=0)[0]
           for name, e in (("bf16", engine), ("int8", engine8))}
    n_free = min(r.tokens.shape[-1] for r in gen.values())
    free = float(np.mean(gen["bf16"].tokens[:, :n_free] == gen["int8"].tokens[:, :n_free]))
    seq = np.concatenate([prompt, np.concatenate([gen["bf16"].semantic[None],
                                                  gen["bf16"].tokens])], axis=1)
    params8 = dict(params, slow=engine8.params["slow"], fast=engine8.params["fast"])
    preds = teacher_forced_predictions(params, cfg, tok, seq)
    preds8 = teacher_forced_predictions(params8, cfg, tok, seq)
    tf = teacher_forced_agreement(preds, preds8)
    mask = preds[2]
    codes = preds[1][mask].T.astype(np.int32)
    codes8 = preds8[1][mask].T.astype(np.int32)
    check(codes.shape == codes8.shape == (cfg.num_codebooks, N_FRAMES),
          f"int8 proxy: teacher-forced codes {codes.shape} / {codes8.shape}")
    pcm, pcm8 = codec.decode(codes)[0], codec.decode(codes8)[0]
    m = min(len(pcm), len(pcm8))
    mel = mel_l1_distance(pcm[:m], pcm8[:m], codec_cfg.spec_transform)
    wave_m = pcm_metrics(pcm[:m], pcm8[:m])
    codec32 = FireflyCodec(init_firefly_params(codec_cfg, seed=1, dtype=torch.float32,
                                               device="cuda"), codec_cfg)
    pcm32 = codec32.decode(codes)[0]
    del codec32
    floor = mel_l1_distance(pcm[:len(pcm32)], pcm32[:len(pcm)], codec_cfg.spec_transform)
    passed = int8_policy.evaluate(tf["combined"], mel, floor, wave_m["snr_db"])
    check(all(np.isfinite(v) for v in (tf["combined"], free, mel, floor)),
          "int8 proxy: a non-finite metric")
    log("int8", f"proxy: teacher-forced agreement {tf['combined']:.4f} over {tf['n']:.0f} "
        f"predictions (slow {tf['slow']:.4f}, fast {tf['fast']:.4f}); free-running "
        f"{free:.4f} over {n_free} frames; mel-L1 {mel:.6f} against the bf16-vs-float32 "
        f"vocoder floor {floor:.6f}; SNR {wave_m['snr_db']:.2f} dB (|pcm|max "
        f"{float(np.abs(pcm).max()):.3e}); int8_policy.evaluate -> "
        f"{'PASS' if passed else 'FAIL'} (criteria {int8_policy.criteria_dict()}; random "
        f"weights, reported only) in {time.perf_counter() - t0:.1f}s")


# --------------------------------------------------------------------------
# Phase parallel: the LM sharded over worlds of ranks on this card
# --------------------------------------------------------------------------

PAR_FRAMES_A = 32  # (a): nccl world of one against the unsharded engine
PAR_FRAMES_B = 32  # (b): tp = 2 against the unsharded engine, by accuracy
PAR_REQUESTS = 4
PAR_NEW = 24  # frames a batcher request
PAR_TIMEOUT_S = 600.0


def check_decode_rank_shape(torch, cfg, tp: int = 2) -> dict:
    """Decode attention at a tp rank's own shape (its q and KV heads)
    through `decode_attention_sharded`, against the plain version with the
    kernels phase's tolerance; timed beside SDPA and the byte bound."""
    from fish_speech_tpu_torch.ops import decode_attention as da

    local = dataclasses.replace(cfg, n_head=cfg.n_head // tp, n_local_heads=cfg.n_local_heads // tp)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    h, kv, hd, n_layer, layer = local.n_head, local.n_local_heads, cfg.head_dim, cfg.n_layer, 5
    heads = (cfg.n_head, cfg.n_local_heads)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731

    def one_row(pos, s):
        return (rnd(1, h, hd), rnd(1, kv, hd), rnd(1, kv, hd),
                torch.tensor([pos], dtype=torch.int32, device=dev),
                rnd(n_layer, 1, kv, s, hd), rnd(n_layer, 1, kv, s, hd))

    g_rows = torch.Generator(device=dev).manual_seed(4322)
    pos_rows = torch.randint(39, 168, (SERVE_ROWS,), generator=g_rows, device=dev,
                             dtype=torch.int32)
    cases = [(f"B=1 pos={p} cache={cfg.max_seq_len}", one_row(p, cfg.max_seq_len))
             for p in (0, 1, 104, cfg.max_seq_len - 1)]
    cases.append((f"B={SERVE_ROWS} cache={SERVE_CACHE} ragged",
                  serving_decode_inputs(torch, local, gen, pos_rows)))
    max_err = 0.0
    for label, (q, kn, vn, p, ck, cv) in cases:
        ck2, cv2 = ck.clone(), cv.clone()
        got = da.decode_attention_sharded(q, kn, vn, p, ck, cv, layer, heads=heads, tp=tp)
        ref = da.decode_attention_plain(q, kn, vn, p, ck2, cv2, layer)
        torch.cuda.synchronize()
        check(torch.equal(ck, ck2) and torch.equal(cv, cv2),
              f"parallel: decode_attention tp={tp} {label}: cache differs from the plain version")
        err, ok = within(torch, got, ref, DECODE_ATOL, DECODE_RTOL)
        check(ok, f"parallel: decode_attention tp={tp} {label}: max abs err {err}")
        max_err = max(max_err, err)
        log("parallel", f"decode_attention at a tp={tp} rank's shape ({h} q heads over {kv} KV "
            f"head) {label}: cache bit-equal, attn max_abs_err={err:.3e} (atol={DECODE_ATOL}, "
            f"rtol={DECODE_RTOL})")
    timed = {}
    for label, args in ((f"B=1 pos=104 cache={cfg.max_seq_len}", cases[2][1]),
                        (f"B={SERVE_ROWS} cache={SERVE_CACHE} ragged", cases[-1][1])):
        timed[label] = t = time_decode(torch, da, local, args, layer)
        log("parallel", f"decode_attention tp={tp} rank {label}: kernel {t['ms']:.4f} ms (eager "
            f"call {t['eager_call_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, sdpa "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']}); "
            f"{t['blocks']} blocks in clusters of {t['cluster']}")
    return {"shape": f"q (B,{h},{hd}), cache ({n_layer},B,{kv},S,{hd}) bf16",
            "max_abs_err": max_err, "timings": timed}


def par_spec(cfg, tok, dtype, parts: dict) -> dict:
    from fish_speech_tpu_torch.config import WhichLM

    return dict(cfg=cfg, token_cfg=tok, lm=WhichLM.FISH_1_5, dtype=dtype, seed=0,
                zero_head_columns=[tok.im_end_id], timeout_s=PAR_TIMEOUT_S,
                engine=dict(cache_len=SERVE_CACHE, prompt_buckets=(64,), slow_impl="xla",
                            fast_frame_impl="xla"),
                parts=parts)


def par_requests(np, cfg, n: int):
    """n seeded requests: 40-token prompts, PAR_NEW frames."""
    return [dict(r, max_new=PAR_NEW, seed=2000 + i)
            for i, r in enumerate(serving_requests(np, cfg)[:n])]


def check_placement(world: dict, label: str) -> str:
    """Every rank of a world took the card of its local id on its host (the
    one card here, cuda:0, for a rank that is local id 0 of its host);
    returns each rank's (host, local id, card)."""
    places = []
    for i, r in enumerate(world["ranks"]):
        p = r["placement"]
        check(p["card"] == f"cuda:{p['local_id']}",
              f"{label}: rank {i} (host {p['host']}, local id {p['local_id']}) took {p['card']}")
        places.append(f"rank {i}: host {p['host']} of {p['hosts']}, local id {p['local_id']} of "
                      f"{p['local_count']}, {p['card']}")
    return "; ".join(places)


def check_world(world: dict, label: str) -> list:
    """Every rank launched both attention kernels and holds no JAX module;
    returns each rank's launch counts."""
    launches = [r["launches"] for r in world["ranks"]]
    for i, r in enumerate(world["ranks"]):
        check(r["foreign_modules"] == [], f"parallel {label}: rank {i} holds {r['foreign_modules']}")
        check(min(r["launches"].values()) > 0,
              f"parallel {label}: rank {i} launched the attention kernels {r['launches']}")
    return launches


def float32_logits(torch, np, params32, cfg, tok, prompt, frames):
    """The float32 evaluation of a run's logits on its own context: the
    slow stack over prompt ++ frames[:-1] (teacher-forced, no cache) and
    the gathered head at each frame's position."""
    from fish_speech_tpu_torch.generate.frame import semantic_head_columns
    from fish_speech_tpu_torch.config import WhichLM
    from fish_speech_tpu_torch.ops.norms import rms_norm
    from fish_speech_tpu_torch.train.loss import slow_forward_full

    dev = params32["norm"].device
    seq = np.concatenate([prompt, frames[:-1, 0].T], axis=1)
    tokens = torch.from_numpy(seq.astype(np.int32))[None].to(dev)
    lens = torch.tensor([seq.shape[1]], dtype=torch.int32, device=dev)
    with torch.no_grad():
        hidden = slow_forward_full(params32, cfg, tok, tokens, lens, remat=False)[0]
        hidden = hidden[prompt.shape[1] - 1:]
        cols = torch.as_tensor(semantic_head_columns(WhichLM.FISH_1_5, tok, cfg), device=dev)
        return (rms_norm(hidden, params32["norm"], cfg.norm_eps)
                @ params32["output"][:, cols]).cpu().numpy()


def run_parallel(torch, np, params, tok, smi) -> dict:
    """The phase on `params` (Fish 1.5's seed-0 weights on the card; the
    worlds run on the device and in the dtype the weights have)."""
    from fish_speech_tpu_torch.config import DualARConfig, FireflyConfig, FishVersion, WhichLM
    from fish_speech_tpu_torch.generate.engine import LMEngine
    from fish_speech_tpu_torch.ops.sampling import BATCHED_REP_PEN_WINDOW, SamplingArgs
    from fish_speech_tpu_torch.parallel import dryrun

    cfg = DualARConfig.fish_speech_1_5()
    dev, dtype = params["norm"].device, params["norm"].dtype
    on = dict(device="cuda", backend="gloo") if dev.type == "cuda" else dict(device="cpu",
                                                                             backend="gloo")
    sampling = SamplingArgs(**SAMPLING)
    prompt = main_prompt(np, cfg)
    base = LMEngine(params, cfg, tok, WhichLM.FISH_1_5, cache_len=SERVE_CACHE,
                    prompt_buckets=(64,), slow_impl="xla", fast_frame_impl="xla", dtype=dtype,
                    device=dev)
    out = {"rank_shape": check_decode_rank_shape(torch, cfg) if dev.type == "cuda" else None}

    # (a) one rank on nccl: bit-equal to the unsharded engine
    part_a = dict(prompts=prompt[None], n=PAR_FRAMES_A, sampling=sampling, seed=5)
    t0 = time.perf_counter()
    world = dryrun.serving_dryrun(1, 1, par_spec(cfg, tok, dtype, {"frames": part_a}),
                                  **dict(on, backend="nccl" if dev.type == "cuda" else "gloo"),
                                  timeout_s=PAR_TIMEOUT_S)
    wall = time.perf_counter() - t0
    ref = dryrun.run_frames(base, part_a)
    check(np.array_equal(world["frames"]["frames"], ref["frames"])
          and np.array_equal(world["frames"]["logits"], ref["logits"]),
          "parallel (a): the nccl world of one differs from the unsharded engine")
    out["world1_nccl"] = {"launches": check_world(world, "(a)"), "wall_s": wall}
    log("parallel", f"(a) a world of one rank on nccl (dp = tp = 1), {PAR_FRAMES_A} frames on "
        f"the unfused path: tokens and logits bit-equal to the unsharded engine; launches "
        f"{out['world1_nccl']['launches']}; the world in {wall:.1f}s")

    # (b) two ranks on this card over gloo at tp = 2
    part_b = dict(prompts=prompt[None], n=PAR_FRAMES_B, sampling=sampling, seed=11)
    codec_cfg = FireflyConfig.for_version(FishVersion.V1_5)
    batch_b = dict(rows=SERVE_ROWS, horizon=SERVE_HORIZON, sampling=sampling,
                   requests=par_requests(np, cfg, PAR_REQUESTS),
                   codec=(codec_cfg, 1, dtype))
    t0 = time.perf_counter()
    world = dryrun.serving_dryrun(1, 2, par_spec(cfg, tok, dtype, {"frames": part_b,
                                                                  "batcher": batch_b}),
                                  **on, timeout_s=PAR_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(world["local_heads"] == (cfg.n_head + 2 * cfg.n_local_heads) // 2,
          f"parallel (b): a rank holds {world['local_heads']} wqkv heads")
    ref = dryrun.run_frames(base, part_b)
    params32 = float32_copy(params)
    errs = []
    for run in (world["frames"], ref):
        f32 = float32_logits(torch, np, params32, cfg, tok, prompt, run["frames"])
        errs.append(float(np.abs(run["logits"][:, 0] - f32).max()))
    del params32
    check(errs[0] <= ACCURACY_FACTOR * errs[1] + 1e-6,
          f"parallel (b): tp = 2 logits {errs[0]:.4e} from the float32 evaluation, the "
          f"unsharded engine's {errs[1]:.4e}")
    same = world["frames"]["frames"] == ref["frames"]
    first_diff = int(np.argmin(same.all(axis=(1, 2)))) if not same.all() else None
    served = world["batcher"]
    spf = served["samples_per_frame"]
    for i, r in enumerate(served["requests"]):
        pcm, n = r["pcm"], sum(c["semantic"].shape[0] for c in r["chunks"])
        check(pcm is not None and pcm.shape[0] == n * spf and bool(np.isfinite(pcm).all()),
              f"parallel (b): request {i}: PCM of {None if pcm is None else pcm.shape[0]} "
              f"samples for its {n} frames of {spf}")
    out["tp2_gloo"] = {"launches": check_world(world, "(b)"), "wall_s": wall,
                       "collective_ms": world["collective_ms"],
                       "frames_s": world["frames"]["seconds"],
                       "logits_err_vs_float32": errs, "token_agreement":
                       float(same.mean()), "frames_per_s": served["frames_per_s"]}
    log("parallel", f"(b) two ranks on one card over gloo at tp = 2 ({world['local_heads']} "
        f"wqkv heads a rank): logits over {PAR_FRAMES_B + 1} frames {errs[0]:.4e} from a float32 "
        f"evaluation on their own context, the unsharded engine's {errs[1]:.4e} (factor "
        f"{ACCURACY_FACTOR}); token agreement with the unsharded engine {same.mean():.4f} "
        f"(first differing frame {first_diff}); {world['frames']['seconds']:.2f}s for the "
        f"{PAR_FRAMES_B + 1} frames and their logits; launches {out['tp2_gloo']['launches']}; "
        f"one all-reduce of 16 x 1024 float32 over tp: {world['collective_ms']['device']:.3f} "
        f"ms on card tensors, {world['collective_ms']['staged']:.3f} ms staged through the "
        f"host; the world in {wall:.1f}s")
    log("parallel", f"(b) {PAR_REQUESTS} requests through the sharded pipeline's "
        f"create_batcher({SERVE_ROWS}, {SERVE_HORIZON}) and its central vocoder: PCM for every "
        f"request, {served['frames']} frames in {served['seconds']:.2f}s, "
        f"{served['frames_per_s']:.1f} frames/s, {served['ticks']} ticks (two ranks sharing "
        f"one card over gloo; not a speed of tensor parallelism); {smi}")

    # (c) two ranks at dp = 2 through the batcher, against the unsharded
    # one on the same (unfused) path; SERVE_ROWS requests fill both ranks'
    # rows. The world is laid out as two hosts of one rank each, dp across
    # the hosts (JAX's pod layout): each rank is local id 0 of its host
    batch_c = dict(rows=SERVE_ROWS, horizon=SERVE_HORIZON, sampling=sampling,
                   requests=par_requests(np, cfg, SERVE_ROWS),
                   engine=dict(dynamic_sampling=True, rep_pen_window=BATCHED_REP_PEN_WINDOW,
                               slow_impl="xla", fast_frame_impl="xla"))
    t0 = time.perf_counter()
    world = dryrun.serving_dryrun(2, 1, par_spec(cfg, tok, dtype, {"batcher": batch_c}),
                                  **on, timeout_s=PAR_TIMEOUT_S, hosts=2)
    wall = time.perf_counter() - t0
    ref = dryrun.run_batcher(base, batch_c)
    agree, total = 0, 0
    for i, (g, r) in enumerate(zip(world["batcher"]["requests"], ref["requests"])):
        a = np.concatenate([g["chunks"][0]["semantic"][None], g["chunks"][0]["tokens"]])
        b = np.concatenate([r["chunks"][0]["semantic"][None], r["chunks"][0]["tokens"]])
        check(a[0, 0] == b[0, 0], f"parallel (c): request {i}'s first semantic token "
              f"{a[0, 0]} differs from the unsharded batcher's {b[0, 0]}")
        n = min(a.shape[1], b.shape[1])
        agree += int((a[:, :n] == b[:, :n]).sum())
        total += max(a.shape[1], b.shape[1]) * a.shape[0]
    places = (check_placement(world, "parallel (c)") if dev.type == "cuda"
              else "the CPU")
    out["dp2_gloo"] = {"launches": check_world(world, "(c)"), "wall_s": wall,
                       "collective_ms": world["collective_ms"],
                       "token_agreement": agree / total,
                       "frames_per_s": world["batcher"]["frames_per_s"],
                       "placement": [r["placement"] for r in world["ranks"]]}
    log("parallel", f"(c) as two hosts of one rank each ({places})")
    log("parallel", f"(c) two ranks on one card over gloo at dp = 2 (8 of the 16 rows a rank): "
        f"{SERVE_ROWS} requests, each one's first semantic token equal to the unsharded "
        f"batcher's, codes agreeing on {agree / total:.4f} of their entries; "
        f"{world['batcher']['frames_per_s']:.1f} frames/s (one card, gloo); launches "
        f"{out['dp2_gloo']['launches']}; the world in {wall:.1f}s")
    del base
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phase train: finetuning at the full Fish-1.5 width, and the trained
# checkpoint served back through the fused kernels
# --------------------------------------------------------------------------

TRAIN_LR = 1e-4
# Card against CPU, the same 3 steps at 2 slow layers: the loss and the
# gradients' global norm within 1e-4 relative at each step; the AdamW
# moments within 1e-4 of each leaf's largest value; every parameter
# within one step's learning rate and all but 0.1% within 1e-2 of it
# (Adam divides each gradient by its own running magnitude, so where a
# gradient is near zero the ulps by which the card's sums differ from
# the CPU's can move its parameter by up to about lr).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_MOMENT_TOL = 1e-4
TRAIN_PARAM_TIGHT = 1e-2  # of lr, for all but TRAIN_OUTLIERS of the parameters
TRAIN_OUTLIERS = 1e-3
TRAIN_WORDS = ("hello", "world", "speak", "the", "text", "voice", "sample", "clone", "fish",
               "card")


def train_batch(np, cfg, tok, seed: int, b: int, s: int) -> dict:
    """A text prefix, then audio frames (semantic ids in range, seeded
    codebooks), right-padded, as numpy arrays."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((b, cfg.num_codebooks + 1, s), np.int32)
    tokens[:, 0] = tok.pad_id
    lens = rng.integers(s * 3 // 4, s + 1, size=b).astype(np.int32)
    for i in range(b):
        t = int(rng.integers(16, 48))
        tokens[i, 0, :t] = rng.integers(1000, 1100, size=t)
        tokens[i, 1:, t:lens[i]] = rng.integers(0, cfg.codebook_size,
                                                 size=(cfg.num_codebooks, lens[i] - t))
        tokens[i, 0, t:lens[i]] = tok.semantic_start_id + tokens[i, 1, t:lens[i]]
    return {"tokens": tokens, "seq_lens": lens}


def train_dataset(np, d, cfg, n: int = 16, seed: int = 0) -> None:
    """n seeded (transcript, codes) pairs in d: stand-in words and
    (num_codebooks, 200-400) codes."""
    rng = np.random.default_rng(seed)
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        frames = int(rng.integers(200, 401))
        np.save(d / f"s{i:02d}.npy", rng.integers(0, cfg.codebook_size, size=(
            cfg.num_codebooks, frames)).astype(np.uint32))
        words = rng.choice(TRAIN_WORDS, size=int(rng.integers(6, 20)))
        (d / f"s{i:02d}.txt").write_text(" ".join(words) + " .")


def write_checkpoint(torch, cfg, d, seed: int) -> None:
    """Random float32 weights (seed) in the upstream names with config.json."""
    from fish_speech_tpu_torch.io.checkpoint import save_lm_params
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params

    d.mkdir(parents=True, exist_ok=True)
    save_lm_params(d / "model.safetensors",
                   init_dual_ar_params(cfg, seed=seed, dtype=torch.float32, device="cuda"), cfg)
    (d / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))


def adam_close(np, got, ref, lr: float):
    """(largest difference, share beyond TRAIN_PARAM_TIGHT x lr) over
    every value of two lists of parameter tensors, in float64 on got's
    device."""
    worst, beyond, total = 0.0, 0, 0
    for a, b in zip(got, ref):
        diff = (a.double() - b.to(a.device).double()).abs()
        worst = max(worst, float(diff.max()))
        beyond += int((diff > TRAIN_PARAM_TIGHT * lr).sum())
        total += diff.numel()
    return worst, beyond / total


def train_card_against_cpu(torch, np, cfg, tok) -> None:
    """3 steps (warmup 1) at full width with 2 slow layers, B = 2, S =
    128, on the card and on this machine's CPU from the same weights."""
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params
    from fish_speech_tpu_torch.train import TrainConfig, init_train_state, make_train_step
    from fish_speech_tpu_torch.train.step import tree_leaves

    cfg2 = dataclasses.replace(cfg, n_layer=2)
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1, total_steps=3)
    batches = [train_batch(np, cfg2, tok, seed=10 + i, b=2, s=128) for i in range(3)]
    card = init_dual_ar_params(cfg2, seed=3, dtype=torch.float32, device="cuda")
    runs = {}
    for dev in ("cpu", "cuda"):  # the card's run updates `card` in place
        params, state = init_train_state(card, tc, device=dev)
        step = make_train_step(cfg2, tok, tc)
        metrics = []
        t0 = time.perf_counter()
        for b in batches:
            params, state, m = step(params, state, {k: torch.from_numpy(v).to(dev)
                                                    for k, v in b.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[dev] = (params, state, metrics, time.perf_counter() - t0)
    (pg, sg, mg, tg), (pc, sc, mc, tcpu) = runs["cuda"], runs["cpu"]
    for i, ((lg, ng), (lc, nc)) in enumerate(zip(mg, mc)):
        check(abs(lg - lc) <= TRAIN_LOSS_RTOL * abs(lc) and abs(ng - nc) <= TRAIN_LOSS_RTOL * nc,
              f"train: step {i} on the card loss {lg} grad_norm {ng}, on the CPU {lc} {nc}")
    moment_err = 0.0
    for key in ("mu", "nu"):
        for (path, a), (_, b) in zip(tree_leaves(sg[key]), tree_leaves(sc[key])):
            err = float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30))
            check(err <= TRAIN_MOMENT_TOL, f"train: {key} {'/'.join(path)} differs from the "
                  f"CPU's by {err:.2e} of its largest value")
            moment_err = max(moment_err, err)
    check(int(sg["count"]) == int(sc["count"]) == 3, "train: the optimizer count is not 3")
    worst, share = adam_close(np, [t for _, t in tree_leaves(pg)], [t for _, t in tree_leaves(pc)],
                              TRAIN_LR)
    check(worst <= TRAIN_LR and share <= TRAIN_OUTLIERS,
          f"train: parameters after 3 steps differ from the CPU's by up to {worst:.2e} "
          f"({share:.2e} of them beyond {TRAIN_PARAM_TIGHT} x lr)")
    rel = max(max(abs(lg - lc) / abs(lc), abs(ng - nc) / nc) for (lg, ng), (lc, nc) in zip(mg, mc))
    log("train", f"card against CPU, full width with 2 slow layers (the 4 fast layers whole), "
        f"B=2 S=128, 3 steps warmup 1, lr {TRAIN_LR}: loss {' '.join(f'{l:.6f}' for l, _ in mg)} "
        f"(CPU {' '.join(f'{l:.6f}' for l, _ in mc)}), largest relative difference of loss and "
        f"grad_norm {rel:.2e} (tol {TRAIN_LOSS_RTOL}); moments within {moment_err:.2e} of each "
        f"leaf's largest (tol {TRAIN_MOMENT_TOL}); parameters within {worst:.2e} (tol lr "
        f"{TRAIN_LR}), {share:.2e} of them beyond {TRAIN_PARAM_TIGHT} x lr (tol "
        f"{TRAIN_OUTLIERS}); card {tg:.2f}s, CPU {tcpu:.1f}s ({torch.get_num_threads()} "
        f"threads)")


def finetune_args(ckpt, data, out, *extra):
    from fish_speech_tpu_torch.cli import finetune

    return finetune.build_parser().parse_args([
        "--checkpoint", str(ckpt), "--data", str(data), "--out", str(out),
        "--seq-len", "512", "--batch-size", "4", "--lr", str(TRAIN_LR), "--warmup", "2",
        *map(str, extra)])


def train_full_depth(torch, np, cfg, d, smi) -> None:
    """12 steps of the finetune CLI's function at full depth on 16 seeded
    pairs, with remat on and off: the loss falls; s/step (median of the
    last 8), real tokens/s and the peak memory (utils/profiling)."""
    from fish_speech_tpu_torch.cli import finetune
    from fish_speech_tpu_torch.utils.profiling import memory_stats

    write_checkpoint(torch, cfg, d / "ckpt", seed=4)
    train_dataset(np, d / "data", cfg)
    for remat in (True, False):
        out = d / ("trained" if remat else "trained_no_remat")
        args = finetune_args(d / "ckpt", d / "data", out, "--steps", 12, "--log-every", 1,
                             *([] if remat else ["--no-remat"]))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        records, seconds = logged(torch, finetune.finetune, StandInTokenizer(cfg.codebook_size),
                                  args, phase="train")
        peak = memory_stats()["cuda:0"]["allocated_bytes.all.peak"]
        losses = [r["loss"] for r in records]
        check(len(records) == 12 and all(np.isfinite(losses)), f"train: losses {losses}")
        check(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")
        ends = [r["seconds"] for r in records]
        steps = np.diff([0.0] + ends)[-8:]
        tokens = sum(r["tokens"] for r in records[-8:])
        log("train", f"full depth (24 + 4 layers), remat {'on' if remat else 'off'}: 12 steps of B=4, seq-len 512 (16 pairs of 200-400 "
            f"frames, lr {TRAIN_LR}, warmup 2) through the finetune CLI's function: loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; {float(np.median(steps)):.4f} s/step "
            f"(median of the last 8), {tokens / float(np.sum(steps)):.0f} real tokens/s; peak "
            f"allocated {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above the "
            f"{base / 1e9:.2f} GB held before); {seconds:.1f}s with the checkpoint's load and "
            f"write; {smi}")
        if not remat:
            shutil.rmtree(out)


def train_resume(torch, np, cfg, d) -> None:
    """At 2 slow layers: 4 steps straight against 2 steps, a snapshot and
    --resume to 4, through the finetune CLI's function; the final train
    states (parameters, moments, count, data-order RNG and permutation)
    and checkpoints are bitwise equal."""
    from fish_speech_tpu_torch.cli import finetune

    cfg2 = dataclasses.replace(cfg, n_layer=2)
    write_checkpoint(torch, cfg2, d / "ckpt2", seed=5)
    tok = StandInTokenizer(cfg.codebook_size)
    straight, resumed = d / "straight", d / "resumed"
    common = (d / "ckpt2", d / "data")
    t0 = time.perf_counter()
    logged(torch, finetune.finetune, tok, finetune_args(*common, straight, "--steps", 4,
                                                        "--save-every", 4), phase="train")
    logged(torch, finetune.finetune, tok, finetune_args(*common, resumed, "--steps", 2,
                                                        "--save-every", 2), phase="train")
    logged(torch, finetune.finetune, tok, finetune_args(*common, resumed, "--steps", 4,
                                                        "--save-every", 2, "--resume"),
           phase="train")
    seconds = time.perf_counter() - t0
    with np.load(straight / "train_state.npz") as a, np.load(resumed / "train_state.npz") as b:
        check(sorted(a.files) == sorted(b.files), "train: the two train states hold other names")
        meta_a, meta_b = (json.loads(bytes(z["__meta__"]).decode()) for z in (a, b))
        check(meta_a == meta_b and meta_a["step"] == 4,
              "train: the resumed run's step, RNG state or permutation differs")
        differ = [k for k in a.files if not np.array_equal(a[k], b[k])]
        n = len(a.files) - 1
    check(not differ, f"train: the resumed run's tensors differ from the straight run's: {differ}")
    check((straight / "model.safetensors").read_bytes() == (resumed / "model.safetensors")
          .read_bytes(), "train: the resumed run's model.safetensors differs")
    log("train", f"resume at 2 slow layers: 4 steps straight, and 2 steps + a snapshot + "
        f"--resume to 4: the {n} tensors of the train states (parameters, AdamW moments, "
        f"count), the step, the data-order RNG's state and permutation, and model.safetensors "
        f"bitwise equal ({seconds:.1f}s for the three runs with their snapshots)")


def train_serve_back(torch, np, cfg, tok, d) -> None:
    """The trained checkpoint in bf16 through load_lm_params into the
    batch-1 `auto` engine: 16 frames from the 40-token prompt through the
    fused kernels, with their launches."""
    from fish_speech_tpu_torch.config import WhichLM
    from fish_speech_tpu_torch.generate.engine import LMEngine
    from fish_speech_tpu_torch.io.checkpoint import load_lm_params
    from fish_speech_tpu_torch.ops import decode_attention as da
    from fish_speech_tpu_torch.ops import fast_frame as ff
    from fish_speech_tpu_torch.ops import prefill_attention as pa
    from fish_speech_tpu_torch.ops import slow_step as ss
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs

    params = load_lm_params(d / "trained", cfg, dtype=torch.bfloat16)
    engine = LMEngine(params, cfg, tok, WhichLM.FISH_1_5, max_frames=16, prompt_buckets=(64,))
    check(engine.use_fused_slow and engine.use_fused_fast,
          "train: the trained checkpoint's engine is not on the fused path")
    mods = {"prefill_attention": pa, "fused_slow_step": ss, "fused_fast_frame": ff,
            "decode_attention": da}
    # the decode loop captured outside the count
    engine.generate(main_prompt(np, cfg), max_new_tokens=16, sampling=SamplingArgs(**SAMPLING),
                    seed=1)
    for m in mods.values():
        m.launches = 0
    res, _ = engine.generate(main_prompt(np, cfg), max_new_tokens=16,
                             sampling=SamplingArgs(**SAMPLING), seed=0)
    launches = {k: m.launches for k, m in mods.items()}
    frames = res.tokens.shape[1]
    sem = res.semantic
    check(1 <= frames <= 16, f"train: served {frames} frames")
    check(bool(((sem >= tok.semantic_start_id) & (sem <= tok.semantic_end_id)).all()),
          f"train: served semantic ids outside the range: {sem}")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.codebook_size)).all()),
          "train: served codebook ids outside [0, codebook_size)")
    # one slow step and one fast frame a decode step: generate decodes
    # whole chunks (the captured loops), a chunk past the one that ends
    steps = launches["fused_slow_step"]
    issued = list(itertools.accumulate(h for h, _ in engine.chunk_plan(15)))
    check(launches["prefill_attention"] == cfg.n_layer and launches["decode_attention"] == 0
          and launches["fused_fast_frame"] == steps and steps in issued
          and steps >= frames - 1, f"train: serving the trained checkpoint's {frames} frames "
          f"launched {launches} (chunks end at {issued})")
    log("train", f"the trained model.safetensors in bf16 through load_lm_params into the "
        f"batch-1 auto engine: {frames} frames from the {PROMPT_LEN}-token prompt, ids in "
        f"range, launches {json.dumps(launches)}")


MESH_B, MESH_S, MESH_STEPS = 4, 256, 2  # (a)-(c): full depth
MESH_RESUME = (2, 128, 4)  # (d): B, S and steps at 2 slow layers, a snapshot after half
# a meshed run against the unsharded one: loss and grad norm within
# 1e-5 relative at each step, the parameters as `adam_close` holds them
MESH_LOSS_RTOL = 1e-5
MESH_TIMEOUT_S = 600.0


def mesh_batches(np, cfg, tok, seed: int, n: int, b: int, s: int) -> list:
    """n seeded global b x s batches (`train_batch`) whose first dp half
    is cut to s / 2 positions: the two dp ranks' rows hold unequal
    counts, so the loss's global count is exercised."""
    out = []
    for i in range(n):
        batch = train_batch(np, cfg, tok, seed=seed + i, b=b, s=s)
        batch["seq_lens"][:b // 2] = s // 2
        batch["tokens"][:b // 2, :, s // 2:] = 0
        batch["tokens"][:b // 2, 0, s // 2:] = tok.pad_id
        out.append(batch)
    return out


def world_line(world: dict, run: int = 0) -> str:
    """A world's seconds a step, collectives a step and their bytes, and
    each rank's peak allocation, from its ranks' results."""
    ranks = [r["runs"][run] for r in world["ranks"]]
    steps = ranks[0]["steps"]
    peaks = [r["peak_bytes"] for r in ranks]
    phases = ", ".join(f"{k} {v:.1f}" for k, v in ranks[0]["seconds"].items())
    return (f"{' '.join('%.3f' % st['seconds'] for st in steps)} s/step, "
            f"{steps[-1]['calls']} collectives {steps[-1]['bytes'] / 1e6:.1f} MB a step on rank "
            f"0, peak allocated a rank "
            f"{' '.join('n/a' if p is None else '%.2f' % (p / 1e9) for p in peaks)} GB; rank "
            f"0's seconds: {phases}")


def check_mesh_run(label: str, world: dict, run: int = 0, bitwise: bool = False) -> str:
    """A meshed run against the unsharded run of the same batches (a
    resumed run: against the last steps of the whole run) on every rank
    that compared: bit for bit (bitwise), or loss and grad norm within
    MESH_LOSS_RTOL and the parameters within `adam_close`'s
    tolerances."""
    for i, r in enumerate(world["ranks"]):
        check(r["foreign_modules"] == [], f"train {label}: rank {i} holds {r['foreign_modules']}")
    got = world["runs"][run]
    ref = got["reference"]
    n = len(got["steps"])
    check(0 < n <= len(ref["steps"]), f"train {label}: {n} steps, {len(ref['steps'])} unsharded")
    pairs = list(zip(got["steps"], ref["steps"][-n:]))
    rel = max(max(abs(g[k] - r[k]) / abs(r[k]) for k in ("loss", "grad_norm")) for g, r in pairs)
    if bitwise:
        check(all(g[k] == r[k] for g, r in pairs for k in r) and ref["bit_equal"],
              f"train {label}: not bit-equal to the unsharded step (largest parameter "
              f"difference {ref['max_abs_diff']:.3e}, metrics {pairs})")
        return "loss, grad norm and every parameter bit-equal to the unsharded step"
    share = ref["beyond"] / ref["total"]
    check(rel <= MESH_LOSS_RTOL, f"train {label}: loss or grad norm {rel:.2e} from the "
          f"unsharded step's (tol {MESH_LOSS_RTOL})")
    check(ref["max_abs_diff"] <= TRAIN_LR and share <= TRAIN_OUTLIERS,
          f"train {label}: parameters {ref['max_abs_diff']:.2e} from the unsharded step's, "
          f"{share:.2e} of them beyond {TRAIN_PARAM_TIGHT} x lr")
    return (f"loss and grad norm within {rel:.2e} relative of the unsharded step's (tol "
            f"{MESH_LOSS_RTOL}); parameters within {ref['max_abs_diff']:.2e} (tol lr "
            f"{TRAIN_LR}), {share:.2e} of them beyond {TRAIN_PARAM_TIGHT} x lr (tol "
            f"{TRAIN_OUTLIERS})")


def train_mesh(torch, np, cfg, tok, d, smi, device: str = "cuda") -> dict:
    """Finetuning under a mesh through `parallel.dryrun.train_dryrun`, each
    world against the unsharded step on the same global batches (float32,
    TF32 off), run by the compared ranks: (a) a world of one rank on nccl
    at full depth, bit for bit; (b) tp = 2 and (c) dp = 2 over gloo, two
    ranks sharing this card, at full depth, (c) as two hosts of one rank
    each, every host fed its block of each global batch (its line shows
    every rank's host, local id and card); (d) at 2 slow layers, in the
    (b) world a straight run with a snapshot after half its steps and a
    resume from it on that world (bit for bit), in the (c) world a resume
    from that snapshot, and one on one device here, each continuation
    against the straight unsharded run. Returns each world's figures."""
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params
    from fish_speech_tpu_torch.parallel import dryrun
    from fish_speech_tpu_torch.train import TrainConfig, init_train_state, make_train_step
    from fish_speech_tpu_torch.train.checkpoint import load_train_state
    from fish_speech_tpu_torch.train.step import tree_leaves

    b2, s2, n2 = MESH_RESUME
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1, total_steps=n2)
    tight = {"tight": TRAIN_PARAM_TIGHT * TRAIN_LR}
    batches = mesh_batches(np, cfg, tok, seed=70, n=MESH_STEPS, b=MESH_B, s=MESH_S)
    cfg2 = dataclasses.replace(cfg, n_layer=2)
    batches2 = mesh_batches(np, cfg2, tok, seed=80, n=n2, b=b2, s=s2)
    snap = str(d / "mesh_1x2.npz")
    full = {"batches": batches, "reference": tight}
    # (c) runs as two hosts of one rank each (dp across the hosts), each
    # host fed its block of every global batch
    runs = {
        "(a)": ((1, 1), "nccl" if device == "cuda" else "gloo", 1, [full]),
        "(b)": ((1, 2), "gloo", 1, [full, {"cfg": cfg2, "batches": batches2,
                                           "resume_check": True,
                                           "save": {"path": snap, "after": n2 // 2},
                                           "reference": tight}]),
        "(c)": ((2, 1), "gloo", 2, [full, {"cfg": cfg2, "batches": batches2[n2 // 2:],
                                           "resume": snap,
                                           "reference": dict(tight, batches=batches2)}]),
    }
    out, held = {}, {}
    t_all = time.perf_counter()
    for label, ((dp, tp), backend, hosts, world_runs) in runs.items():
        t0 = time.perf_counter()
        world = dryrun.train_dryrun(dp, tp, dict(cfg=cfg, token_cfg=tok, tcfg=tc,
                                                 dtype=torch.float32, seed=6, runs=world_runs),
                                    device=device, backend=backend, timeout_s=MESH_TIMEOUT_S,
                                    hosts=hosts)
        wall = time.perf_counter() - t0
        run = world["runs"][0]
        line = check_mesh_run(label, world, bitwise=(dp, tp) == (1, 1))
        if hosts > 1:
            places = (check_placement(world, f"train {label}") if device == "cuda"
                      else "the CPU")
            log("train", f"mesh {label} as {hosts} hosts of {dp * tp // hosts} rank(s), each "
                f"host fed its {MESH_B // hosts} of the {MESH_B} rows of every global batch "
                f"({places}); training launches no kernel of the table")
        out[label] = {"world": (dp, tp), "hosts": hosts, "backend": backend, "wall_s": wall,
                      "steps": [r["runs"][0]["steps"] for r in world["ranks"]],
                      "peak_bytes": [r["runs"][0]["peak_bytes"] for r in world["ranks"]],
                      "reference": {k: v for k, v in run["reference"].items() if k != "steps"}}
        log("train", f"mesh {label} dp={dp} tp={tp} on {backend}, full depth ({cfg.n_layer} + "
            f"{cfg.n_fast_layer} layers), B={MESH_B} S={MESH_S} (rows 0-{MESH_B // 2 - 1} cut to "
            f"{MESH_S // 2}), {MESH_STEPS} steps warmup 1 lr {TRAIN_LR}: loss "
            f"{' '.join('%.6f' % st['loss'] for st in run['steps'])} grad norm "
            f"{' '.join('%.6f' % st['grad_norm'] for st in run['steps'])}; {line}; "
            f"{world_line(world)}; the world in {wall:.1f}s"
            + ("" if label == "(a)" else " with its part of (d)")
            + ("" if dp * tp == 1 else " (two ranks sharing one card over gloo: not a speed "
               "of tensor or data parallelism)") + f"; {smi}")
        if label == "(b)":
            differs = [r["runs"][1]["resume_differs"] for r in world["ranks"]]
            check(differs == [[], []], f"train (d): the resume at (1, 2) differs from its "
                  f"straight run in {differs}")
        if label != "(a)":
            held[label] = (check_mesh_run(f"(d) at {(dp, tp)}", world, run=1),
                           world_line(world, run=1))

    # (d) on one device: the straight run here, and the resume from the snapshot
    t0 = time.perf_counter()
    step = make_train_step(cfg2, tok, tc)
    res = {}
    for name, resume in (("straight", None), ("resumed", snap)):
        params, state = init_train_state(init_dual_ar_params(cfg2, seed=6, dtype=torch.float32,
                                                             device=device), tc)
        first = 0
        if resume:
            first, params, state, _, _ = load_train_state(resume, params, state)
        for b in batches2[first:]:
            params, state, m = step(params, state, {k: torch.from_numpy(v).to(device)
                                                    for k, v in b.items()})
        res[name] = ([t for _, t in tree_leaves(params)], float(m["loss"]))
    worst, share = adam_close(np, res["resumed"][0], res["straight"][0], TRAIN_LR)
    rel = abs(res["resumed"][1] - res["straight"][1]) / abs(res["straight"][1])
    check(worst <= TRAIN_LR and share <= TRAIN_OUTLIERS and rel <= MESH_LOSS_RTOL,
          f"train (d): the one-device resume is {worst:.2e} from the straight run ({share:.2e} "
          f"beyond {TRAIN_PARAM_TIGHT} x lr; last loss {rel:.2e} relative)")
    del res
    out["(d)"] = {"one_device_s": time.perf_counter() - t0,
                  "all_s": time.perf_counter() - t_all}
    log("train", f"mesh (d) at 2 slow layers, B={b2} S={s2}, {n2} steps: at (1, 2) with a "
        f"snapshot after {n2 // 2}, the resume on (1, 2) bit for bit its straight run on each "
        f"rank (parameters, moments, count); the straight (1, 2) run: {held['(b)'][0]} "
        f"({held['(b)'][1]}); resumed at (2, 1), against the straight unsharded run: "
        f"{held['(c)'][0]} ({held['(c)'][1]}); resumed on one device: parameters within "
        f"{worst:.2e}, {share:.2e} beyond {TRAIN_PARAM_TIGHT} x lr, last loss {rel:.2e} "
        f"relative ({out['(d)']['one_device_s']:.1f}s); the mesh lines in "
        f"{out['(d)']['all_s']:.1f}s")
    return out


def run_train(torch, np, tok) -> None:
    import tempfile
    from pathlib import Path

    from fish_speech_tpu_torch.config import DualARConfig

    cfg = DualARConfig.fish_speech_1_5()
    check(not torch.backends.cuda.matmul.allow_tf32, "train: TF32 is on for matmuls")
    train_card_against_cpu(torch, np, cfg, tok)
    smi = nvidia_smi_line()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        train_full_depth(torch, np, cfg, d, smi)
        train_resume(torch, np, cfg, d)
        train_serve_back(torch, np, cfg, tok, d)
        train_mesh(torch, np, cfg, tok, d, smi)
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Cold start: a fresh process to its first audio, with and without the
# kernel library built
# --------------------------------------------------------------------------

COLD_FRAMES = 16


def cold_start_child() -> int:
    """`chip_smoke.py --cold-start`: import, kernel library (built or
    loaded under $FISH_TPU_CACHE_DIR), the batch-1 engine and the
    Firefly-1.5 codec from seeded bf16 weights, the first prefill, the
    first 16-frame decode_chunk and the first Firefly decode, each timed
    to the card's last work; one JSON line of seconds."""
    t0 = time.perf_counter()
    import numpy as np
    import torch

    from fish_speech_tpu_torch.config import (
        DualARConfig, FireflyConfig, FishVersion, TokenConfig, WhichLM)
    from fish_speech_tpu_torch.generate.engine import LMEngine
    from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec, init_firefly_params
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params
    from fish_speech_tpu_torch.ops import _cuda_build
    from fish_speech_tpu_torch.ops.sampling import SamplingArgs
    from fish_speech_tpu_torch.utils.cache import setup_compilation_cache

    cache = setup_compilation_cache()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    out = {"import_s": time.perf_counter() - t0}
    t = time.perf_counter()
    _cuda_build.load_library()
    out["library_s"] = time.perf_counter() - t
    out["built"] = _cuda_build.build_seconds is not None
    t = time.perf_counter()
    cfg = DualARConfig.fish_speech_1_5()
    tok = TokenConfig(im_end_id=100011, pad_id=5, semantic_start_id=100012,
                      semantic_end_id=100012 + cfg.codebook_size - 1)
    params = init_dual_ar_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    params["output"][:, tok.im_end_id] = 0
    engine = LMEngine(params, cfg, tok, WhichLM.FISH_1_5, cache_len=SERVE_CACHE,
                      max_frames=COLD_FRAMES, prompt_buckets=(64,))
    codec_cfg = FireflyConfig.for_version(FishVersion.V1_5)
    codec = FireflyCodec(init_firefly_params(codec_cfg, seed=1, dtype=torch.bfloat16,
                                             device="cuda"), codec_cfg)
    torch.cuda.synchronize()
    out["engine_s"] = time.perf_counter() - t
    sampling = SamplingArgs(**SAMPLING)
    t = time.perf_counter()
    state, first, _, _ = engine._prefill_raw(engine.init_state(0), main_prompt(np, cfg), sampling)
    frames = [first.cpu().numpy()[0]]
    out["prefill_s"] = time.perf_counter() - t
    t = time.perf_counter()
    state, chunk, valid, steps = engine.decode_chunk(state, sampling, COLD_FRAMES)
    chunk, valid, steps = (x.cpu().numpy() for x in (chunk, valid, steps))
    frames += [chunk[i, 0] for i in range(int(steps)) if valid[i, 0]]
    out["decode_chunk_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pcm = codec.decode(np.stack(frames, axis=1)[1:])
    torch.cuda.synchronize()
    out["firefly_s"] = time.perf_counter() - t
    out["total_s"] = time.perf_counter() - t0
    out["frames"] = len(frames)
    out["pcm_finite"] = bool(np.isfinite(pcm).all()) and pcm.shape[-1] > 0
    out["cache"] = cache
    out["nvcc_log"] = _cuda_build.nvcc_log
    print(json.dumps(out), flush=True)
    return 0


def run_cold(smi):
    """Two fresh processes to the first audio with $FISH_TPU_CACHE_DIR at
    one new directory: the first builds the kernel library there, the
    second finds it built. Returns the directory, the first process's
    build seconds and its nvcc log."""
    import os
    import tempfile
    from pathlib import Path

    cache = tempfile.mkdtemp(prefix="fish_tpu_kernels_")
    env = dict(os.environ, FISH_TPU_CACHE_DIR=cache)
    first = None
    for label, built in (("empty cache", True), ("library built", False)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--cold-start"],
                              env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"cold: the {label} process failed: {proc.stderr[-3000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        check(r["built"] == built and r["cache"] == cache and r["pcm_finite"],
              f"cold: {label}: {dict(r, nvcc_log='...')}")
        first = first or r
        log("cold", f"{label}: a fresh process to its first audio in {r['total_s']:.2f}s "
            f"({wall:.2f}s with the interpreter's start and exit): import and CUDA init "
            f"{r['import_s']:.2f}s, kernel library {'built' if built else 'loaded'} "
            f"{r['library_s']:.2f}s, engine and codec from seeded weights "
            f"{r['engine_s']:.2f}s, first prefill {r['prefill_s']:.3f}s, first "
            f"{COLD_FRAMES}-frame decode_chunk {r['decode_chunk_s']:.3f}s, first Firefly "
            f"decode of {r['frames'] - 1} frames {r['firefly_s']:.3f}s; {smi}")
    return cache, first["library_s"], first["nvcc_log"]


def log_ptxas(nvcc_log: str) -> None:
    """ptxas's register, stack and shared-memory line of each kernel,
    once, with the sources that compile it."""
    units, lines = {}, {}
    unit, kernel = "?", "?"
    types = {"a": "int8", "13__nv_bfloat16": "bf16", "Lb0E": "false", "Lb1E": "true"}
    for line in nvcc_log.splitlines():
        if line.startswith("== "):
            unit = line[3:].strip()
            continue
        entry = re.search(
            r"Compiling entry function '.*?([a-z_]+_kernel)(I(?:Li-?\d+E|Lb[01]E|13__nv_bfloat16|a)+E)?",
            line)
        if entry:
            args = re.findall(r"Li(-?\d+)E|(13__nv_bfloat16|a|Lb[01]E)", entry.group(2) or "")
            args = [n or types[t] for n, t in args]
            kernel = entry.group(1) + (f"<{','.join(args)}>" if args else "")
            units.setdefault(kernel, []).append(unit)
        elif "registers" in line:
            lines.setdefault(kernel, line.split(":", 1)[1].strip())
    for kernel, line in lines.items():
        log("build", f"ptxas {kernel} ({', '.join(units[kernel])}): {line}")


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from fish_speech_tpu_torch.config import DualARConfig
        from fish_speech_tpu_torch.ops import _cuda_build
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})", file=sys.stderr)
        return 2

    # parity is checked in full float32: no TF32 in matmuls or
    # convolutions, no bf16 split-K reductions in cuBLAS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = nvidia_smi_line()
    log("device", f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvidia-smi: {smi}")

    # the cold start's first process builds the kernel library into a new
    # directory, which this process then loads: one build a run
    from fish_speech_tpu_torch.utils.cache import setup_compilation_cache

    with phase("cold"):
        cache, built, nvcc_log = run_cold(smi)
    atexit.register(shutil.rmtree, cache, ignore_errors=True)
    setup_compilation_cache(cache)
    with phase("build"):
        t0 = time.perf_counter()
        _cuda_build.load_library()
        n_src = len(list(_cuda_build.CSRC.glob("*.cu")))
        log("build", f"{n_src} x nvcc {' '.join(_cuda_build.NVCC_FLAGS[:2])} -c, in parallel, "
            f"+ link -> libfstorch.so: built in {built:.1f}s by the cold start's first process "
            f"(load here {time.perf_counter() - t0:.2f}s)")
        log_ptxas(nvcc_log)
        n_tensor = sass_tensor_ops(_cuda_build.find_nvcc(), _cuda_build.build())
        log("build", f"cuobjdump -sass: {n_tensor} HGMMA/HMMA instructions in "
            "prefill_attention_kernel")
        check(n_tensor > 0, "prefill_attention_kernel has no tensor-core instruction")

    cfg = DualARConfig.fish_speech_1_5()
    cache_len = cfg.max_seq_len
    main_pos = PROMPT_LEN + N_FRAMES // 2
    with phase("kernels"):
        kernels = [
            check_decode_kernel(torch, cfg, cache_len, main_pos=main_pos),
            check_prefill_kernel(torch, cfg, cache_len, n_tensor),
        ]
        fused, unfused, serving, int8, codec, tok, codec_cfg, params = build_models(torch)
        with torch.inference_mode():
            for batch1, rows in ((fused, serving["auto"]), (int8["batch1"], int8["serving"])):
                params32 = float32_copy(batch1.params)
                kernels += [check_slow_step(torch, batch1, params32, main_pos),
                            check_fast_frame(torch, batch1, params32),
                            check_fast_frame_batched(torch, rows, params32),
                            check_slow_step_rows(torch, rows, params32)]
                kernels[-2]["gemms"] = check_rows_gemms(torch, rows)
                del params32
    with phase("main"):
        launches, bf16_stats = run_main_path(torch, np, fused, unfused, codec, tok, codec_cfg)
    with phase("prefill"), torch.inference_mode():
        long_prefill = run_long_prefill(torch, np, params, fused.cfg, tok)
    next(k for k in kernels if k["name"] == "prefill_attention")["long_prefill"] = long_prefill
    with phase("main int8"):
        launches.update(run_int8_main_path(torch, np, int8["batch1"], fused, bf16_stats, codec,
                                           tok, codec_cfg))
    # from here on the codec is loud enough for int16 (`loud_codec`)
    with phase("stream"):
        loud, loud32, bound16 = run_stream(torch, np, codec, codec_cfg, smi)
    with phase("overlap"):
        run_overlap(torch, np, fused, loud, loud32, codec_cfg, bound16, smi)
    with phase("ttfa"):
        run_ttfa(torch, np, params, fused.cfg, tok, loud, smi)
    with phase("cli"):
        run_cli(torch, np, params, fused.cfg, tok, codec_cfg, smi)
    # after ttfa: its torch.profiler sessions leave host-bound work slower
    with phase("graph"):
        run_graph(torch, np, fused, unfused, int8, loud, smi)
    with phase("serving"):
        served = run_serving(torch, np, dict(serving, int8=int8["serving"]), loud, loud32, tok,
                             codec_cfg, bound16)
    with phase("server"):
        server, _ = run_server(torch, np, params, fused.cfg, tok, loud, codec_cfg, bound16,
                               smi)
    del loud, loud32
    with phase("versions"):
        versions = run_versions(torch, np, smi)
    for name in ("fused_fast_frame_batched", "fused_fast_frame_batched_int8", "slow_step_rows",
                 "slow_step_rows_int8"):
        launches[name] = served[name]
    with phase("int8 proxy"):
        run_int8_proxy(torch, np, fused, int8["batch1"], params, codec, codec_cfg)
    with phase("parallel"):
        parallel = run_parallel(torch, np, params, tok, smi)
    for name in ("decode_attention", "prefill_attention"):
        k = next(k for k in kernels if k["name"] == name)
        k["parallel_launches"] = {w: [r[name] for r in v["launches"]]
                                  for w, v in parallel.items() if w != "rank_shape"}
    next(k for k in kernels if k["name"] == "decode_attention")["tp2_rank_shape"] = \
        parallel["rank_shape"]
    with phase("train"):
        run_train(torch, np, tok)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path")
        if k["name"] in server:
            k["server_launches"] = server[k["name"]]
        if not k["name"].endswith("_int8"):
            k["version_launches"] = {v: r["launches"][k["name"]] for v, r in versions.items()}
            check(all(k["version_launches"].values()),
                  f"{k['name']} was not launched on every version's path: "
                  f"{k['version_launches']}")
        k["versions"] = {v: r["kernels"][k["name"]] for v, r in versions.items()
                         if k["name"] in r["kernels"]}

    log("done", f"every phase held, in {time.perf_counter() - T0:.1f}s")
    # the bulky per-kernel extras on a line of their own, so that the
    # phase summary and the kernels line fit the output's 24,000-byte tail
    details = {k["name"]: {key: k.pop(key) for key in DETAIL_KEYS if key in k}
               for k in kernels}
    print(json.dumps({"kernel_details": details}), flush=True)
    for name, seconds in PHASES:
        print(f"phase {name}: {seconds:.1f}s, held", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(cold_start_child() if sys.argv[1:] == ["--cold-start"] else main())
