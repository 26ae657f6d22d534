"""Batch-1 LMEngine: prompt -> first frame -> decode loop -> codes.

Counterpart of `fish_speech_tpu/generate/engine.py` for batch-1 engines
with flash prefill (`prefill_impl="flash"`) and the JAX engine's choice
of decode path:

* `slow_impl` / `fast_frame_impl` "fused": each decode frame is
  `embed_tokens` -> `ops/slow_step.py::fused_slow_step` -> semantic draw
  -> `ops/fast_frame.py::fused_fast_frame` (the JAX engine's default
  batch-1 path on a TPU);
* "xla", the JAX engine's name for the unfused path: the slow step is
  `models/dual_ar.py::slow_decode_step` with `ops/decode_attention.py`
  (`attention_impl="pallas"`), the codebook loop that of
  `generate/frame.py`;
* "auto" (default): fused on CUDA at batch 1, unfused on the CPU, as the
  JAX engine's "auto" is fused on a TPU at batch 1 only.

On CUDA tensors every fused step and attention call launches the
port's kernels; on CPU tensors they run their plain versions. It runs
eagerly, one frame per Python iteration. There is no CUDA graph yet.

* Prompts are right-padded to a bucket and prefilled in one call; the
  attention read extent is the smallest bucket covering offset + bucket.
* The decode loop stops when the row emits <|im_end|> or the frame
  budget is spent, and syncs with the host once per frame for that test.
* `rewind` keeps a conditioning prefix: only the position counter moves.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fish_speech_tpu_torch.config import DualARConfig, TokenConfig, WhichLM
from fish_speech_tpu_torch.device import resolve_device, tree_to
from fish_speech_tpu_torch.generate.frame import (
    FrameResult,
    draw_frame_noise,
    generate_frame,
    semantic_head_columns,
)
from fish_speech_tpu_torch.models.dual_ar import (
    KVCache,
    embed_tokens,
    rope_tables,
    slow_decode_step,
    slow_prefill,
)
from fish_speech_tpu_torch.ops.fast_frame import fused_fast_frame_supported
from fish_speech_tpu_torch.ops.sampling import (
    SINGLE_STREAM_REP_PEN_WINDOW,
    RepPenWindow,
    SamplingArgs,
)
from fish_speech_tpu_torch.ops.slow_step import fused_slow_step, fused_slow_step_supported

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)


class GenState(NamedTuple):
    """Decode state of the batch-1 engine. The cache is updated in place;
    the other fields are replaced frame by frame."""

    cache: KVCache
    pos: torch.Tensor  # (B,) int32: per-row cache length / next write slot
    prev: torch.Tensor  # (B, C+1) int32: last emitted frame
    rep_pen: RepPenWindow  # tokens (B, C, W)
    generator: torch.Generator  # sampling noise
    done: torch.Tensor  # (B,) bool


class GenerationResult(NamedTuple):
    tokens: np.ndarray  # (num_codebooks, T): codebook rows only
    semantic: np.ndarray  # (T,): semantic row (vocab ids)
    frames: int
    hit_max: bool
    prefill_s: float
    decode_s: float
    prompt_tokens: int


def _bucket_for(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"Prompt length {n} exceeds the largest bucket {buckets[-1]}")


class LMEngine:
    """Owns the (head-gathered) parameters and runs batch-1 generation.
    Not thread-safe."""

    def __init__(
        self,
        params,
        cfg: DualARConfig,
        token_cfg: TokenConfig,
        lm: WhichLM,
        *,
        cache_len: Optional[int] = None,
        max_frames: int = 2048,
        prompt_buckets=DEFAULT_BUCKETS,
        dtype=torch.bfloat16,
        device="cuda",
        slow_impl: str = "auto",
        fast_frame_impl: str = "auto",
    ) -> None:
        self.device = resolve_device(device)
        # Gather the LM head down to the audio-legal columns once; the
        # full head is not kept.
        params = dict(params)
        cols = torch.as_tensor(semantic_head_columns(lm, token_cfg, cfg), dtype=torch.long)
        params["output"] = params["output"][:, cols.to(params["output"].device)].contiguous()
        self.params = tree_to(params, self.device)
        self.cfg = cfg
        self.token_cfg = token_cfg
        self.lm = lm
        self.batch_size = 1
        self.cache_len = cache_len or cfg.max_seq_len
        self.max_frames = max_frames
        self.prompt_buckets = tuple(
            b for b in prompt_buckets if b <= self.cache_len) or (self.cache_len,)
        self.dtype = dtype
        self.rope = rope_tables(cfg, self.device)
        self.use_fused_slow = self._pick(
            "slow_impl", slow_impl,
            fused_slow_step_supported(cfg, self.params, self.batch_size, self.cache_len))
        self.use_fused_fast = self._pick(
            "fast_frame_impl", fast_frame_impl,
            fused_fast_frame_supported(cfg, self.params, self.batch_size))

    def _pick(self, name: str, impl: str, supported: bool) -> bool:
        """"fused" | "xla" | "auto" -> whether the fused path runs."""
        if impl not in ("auto", "fused", "xla"):
            raise ValueError(f"{name} must be 'auto', 'fused' or 'xla', got {impl!r}")
        if impl == "auto":
            return supported and self.device.type == "cuda" and self.batch_size == 1
        if impl == "fused" and not supported:
            raise ValueError(f"{name}='fused': the fused path does not take this "
                             "configuration (batch, head dim, int8 or shared memory)")
        return impl == "fused"

    # -- state ------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> GenState:
        if seed is None:
            seed = int(np.random.default_rng().integers(0, 2**31 - 1))
        b, c = self.batch_size, self.cfg.num_codebooks
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed) & 0x7FFFFFFF)
        dev = self.device
        return GenState(
            cache=KVCache.init(self.cfg.n_layer, b, self.cfg.n_local_heads,
                               self.cache_len, self.cfg.head_dim, self.dtype, dev),
            pos=torch.zeros((b,), dtype=torch.int32, device=dev),
            prev=torch.zeros((b, c + 1), dtype=torch.int32, device=dev),
            rep_pen=RepPenWindow.init((b, c), SINGLE_STREAM_REP_PEN_WINDOW, dev),
            generator=gen,
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    def rewind(self, state: GenState, length: int) -> GenState:
        """Keep the first `length` cache positions, reset everything else."""
        b, c = self.batch_size, self.cfg.num_codebooks
        dev = self.device
        return GenState(
            cache=state.cache,
            pos=torch.full((b,), length, dtype=torch.int32, device=dev),
            prev=torch.zeros((b, c + 1), dtype=torch.int32, device=dev),
            rep_pen=RepPenWindow.init((b, c), SINGLE_STREAM_REP_PEN_WINDOW, dev),
            generator=state.generator,
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    # -- steps ------------------------------------------------------------

    def _kv_extent_for(self, offset: int, bucket: int) -> int:
        need = min(offset + bucket, self.cache_len)
        for b in self.prompt_buckets:
            if need <= b:
                return b
        return self.cache_len

    def _noise(self, state: GenState, sampling: SamplingArgs):
        return draw_frame_noise(
            self.lm, self.cfg, sampling, self.batch_size,
            self.params["output"].shape[1], state.generator, self.device)

    @torch.inference_mode()
    def prefill(self, state: GenState, prompt: np.ndarray, sampling: SamplingArgs,
                offset: int = 0) -> Tuple[GenState, torch.Tensor, torch.Tensor]:
        """Prefill a (C+1, S) prompt at cache position `offset` and sample
        the first frame. Returns (state, frame (1, C+1), is_eos (1,))."""
        prompt = np.asarray(prompt)
        if prompt.ndim == 3:
            prompt = prompt[0]
        rows, s = prompt.shape
        if rows != self.cfg.num_codebooks + 1:
            raise ValueError(f"prompt has {rows} rows, expected {self.cfg.num_codebooks + 1}")
        bucket = _bucket_for(s, self.prompt_buckets)
        padded = np.zeros((1, rows, bucket), np.int32)
        padded[0, :, :s] = prompt
        tokens = torch.from_numpy(padded).to(self.device)
        seq_lens = torch.full((1,), s, dtype=torch.int32, device=self.device)
        logits, hidden = slow_prefill(
            self.params, self.cfg, self.token_cfg, tokens, seq_lens, state.cache,
            offset, self.rope, kv_extent=self._kv_extent_for(offset, bucket))
        res: FrameResult = generate_frame(
            self.params, self.cfg, self.token_cfg, self.lm, sampling, logits, hidden,
            RepPenWindow.init((1, self.cfg.num_codebooks), SINGLE_STREAM_REP_PEN_WINDOW,
                              self.device),
            None, self._noise(state, sampling), self.rope)
        state = state._replace(
            pos=offset + seq_lens, prev=res.tokens, rep_pen=res.rep_pen, done=res.is_eos)
        return state, res.tokens, res.is_eos

    @torch.inference_mode()
    def decode_step(self, state: GenState, sampling: SamplingArgs
                    ) -> Tuple[GenState, torch.Tensor]:
        """One frame: slow step, semantic draw, fast codebook loop. A row
        that is done keeps emitting EOS frames and stops advancing."""
        if self.use_fused_slow:
            x0 = embed_tokens(self.params, self.cfg, self.token_cfg,
                              state.prev[:, :, None])[:, 0, :]
            logits, hidden = fused_slow_step(
                self.params, self.cfg, x0, state.pos, state.cache.k, state.cache.v,
                self.rope)
        else:
            logits, hidden = slow_decode_step(
                self.params, self.cfg, self.token_cfg, state.prev, state.cache,
                state.pos, self.rope)
        res = generate_frame(
            self.params, self.cfg, self.token_cfg, self.lm, sampling, logits, hidden,
            state.rep_pen, state.prev, self._noise(state, sampling), self.rope,
            use_fused_fast=self.use_fused_fast)
        eos_frame = torch.zeros_like(state.prev)
        eos_frame[:, 0] = self.token_cfg.im_end_id
        frame = torch.where(state.done[:, None], eos_frame, res.tokens)
        state = state._replace(
            pos=torch.where(state.done, state.pos, state.pos + 1),
            prev=frame, rep_pen=res.rep_pen, done=state.done | res.is_eos)
        return state, frame

    def generate(self, prompt: np.ndarray, *, max_new_tokens: int = 1024,
                 sampling: Optional[SamplingArgs] = None,
                 state: Optional[GenState] = None, conditioning_offset: int = 0,
                 seed: Optional[int] = None) -> Tuple[GenerationResult, GenState]:
        """Blocking generation for one (C+1, S) prompt. Returns codebook
        rows (C, T) and the semantic row; the first frame is always kept,
        even if it is EOS."""
        sampling = sampling or SamplingArgs()
        if state is None:
            state = self.init_state(seed)
        prompt = np.asarray(prompt)
        prompt_len = prompt.shape[-1]
        t0 = time.perf_counter()
        state, first, _ = self.prefill(state, prompt, sampling, offset=conditioning_offset)
        frames: List[torch.Tensor] = [first[0]]
        self._sync()
        prefill_s = time.perf_counter() - t0

        budget = max(min(
            max_new_tokens - 1,
            self.max_frames,
            self.cache_len - (conditioning_offset + prompt_len) - 1,
        ), 0)
        t1 = time.perf_counter()
        steps = 0
        done = bool(state.done[0])
        while steps < budget and not done:
            state, frame = self.decode_step(state, sampling)
            steps += 1
            done = bool(state.done[0])  # one host sync per frame
            if int(frame[0, 0]) != self.token_cfg.im_end_id:
                frames.append(frame[0])
        stacked = torch.stack(frames, dim=1).cpu().numpy()  # (C+1, T)
        decode_s = time.perf_counter() - t1
        result = GenerationResult(
            tokens=stacked[1:],
            semantic=stacked[0],
            frames=stacked.shape[1],
            hit_max=steps >= budget > 0 and not done,
            prefill_s=prefill_s,
            decode_s=decode_s,
            prompt_tokens=prompt_len,
        )
        return result, state

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
