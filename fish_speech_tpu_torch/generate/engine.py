"""LMEngine: prompt -> first frame -> decode loop -> codes.

Counterpart of `fish_speech_tpu/generate/engine.py` with flash prefill
(`prefill_impl="flash"`), for batch-1 engines and for the batched
engines of continuous serving:

* static sampling (default): one `SamplingArgs` per call and one
  `torch.Generator` for the noise; `generate` drives batch 1.
* `dynamic_sampling=True` (serving): per-row temp/top_p/top_k/rep-pen as
  tensors (`GenState.samp`) and one noise stream per row
  (`generate.frame.RowNoise`), so a seeded request's draws depend only on
  its own seed and frame count. `prefill_row(s)` admits requests into
  rows of a shared cache, `decode_chunk` decodes a horizon of frames for
  all rows, and `generate_batch` runs a fixed batch of ragged prompts.

The decode path follows the JAX engine's choice:

* `slow_impl` "fused": `ops/slow_step.py::fused_slow_step` (on CUDA the
  persistent kernel at 1-4 rows, the row kernel at 5 and more, within
  the JAX kernel's bounds); "xla", the JAX engine's name for the unfused
  path: `models/dual_ar.py::slow_decode_step` with
  `ops/decode_attention.py`; "auto" (default): fused on CUDA at batch 1
  and at 5 rows and more, unfused otherwise. The JAX `auto` leaves the
  batched kernel off for a TPU reason (its per-row flat-lane attention
  expansion); on the H100 the fused 16-row step served more frames a
  second than the unfused one (`chip_smoke.py`'s serving A/B, PERF.md).
* `fast_frame_impl` "fused": one call for the codebook loop,
  `ops/fast_frame.py::fused_fast_frame` (static, batch 1) or
  `ops/fast_frame_batched.py::fused_fast_frame_batched` (dynamic, B <=
  32); "xla": the codebook loop of `generate/frame.py`; "auto": fused on
  CUDA where supported (batch 1 static, any B dynamic). The JAX `auto`
  leaves the batched kernel off for a TPU reason (its VMEM-bounded
  row-block grid and serialised per-row sampler); this port has neither.

On CUDA tensors every fused step and attention call launches the port's
kernels, which take bfloat16 only, apart from int8-quantized matmul
stacks with bfloat16 scales: a CUDA engine refuses other weights or a
cache of another dtype at construction. On CPU tensors they run their
plain versions. The engine runs eagerly; there is no CUDA graph.

`quantize_int8=True` quantizes the slow and fast matmul stacks after the
head gather (`ops/quant.py`, as the JAX engine does at engine.py:154-167)
and keeps no bf16 copy of them; a tree that is quantized already (a JAX
tree through `io.convert`) runs the same way without the flag. The fused
kernels take the int8 stacks as they are; the unfused paths convert each
int8 weight to the activation dtype at every product.

* Prompts are right-padded to a bucket, and each row is prefilled by a
  call of its own (see `_prefill_rows_raw`); the attention read extent is
  the smallest bucket covering offset + bucket.
* `generate` reads the device once a frame (its stop test);
  `decode_chunk` never reads it: outputs, valid flags and an "all rows
  done" marker stay on the card until the caller fetches them.
* `_prefill_raw` and `generate(collect_hidden=True)` also give the slow
  hidden state each frame was drawn from; `warmup` runs the smallest
  prompt bucket (or the buckets, conditioning offsets and decode-chunk
  horizons it is given) once.
* `rewind` keeps a conditioning prefix: only the position counter moves.
"""

from __future__ import annotations

import logging
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fish_speech_tpu_torch.config import DualARConfig, TokenConfig, WhichLM
from fish_speech_tpu_torch.device import resolve_device, tree_to
from fish_speech_tpu_torch.generate.frame import (
    FrameNoise,
    FrameResult,
    NoiseLayout,
    RowNoise,
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
from fish_speech_tpu_torch.ops import decode_stack
from fish_speech_tpu_torch.ops.fast_frame import fused_fast_frame_supported
from fish_speech_tpu_torch.ops.fast_frame_batched import fused_fast_frame_batched_supported
from fish_speech_tpu_torch.ops.quant import is_quantized, quantize_lm_params
from fish_speech_tpu_torch.ops.sampling import (
    SINGLE_STREAM_REP_PEN_WINDOW,
    RepPenWindow,
    RowSampling,
    SamplingArgs,
)
from fish_speech_tpu_torch.ops.slow_step import (
    MAX_BATCH as PERSISTENT_ROWS, fused_slow_step, fused_slow_step_supported, padded_head)

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)

logger = logging.getLogger(__name__)


class GenState(NamedTuple):
    """Decode state of an engine. The cache and the noise streams are
    updated in place; the other tensors are replaced, never written, once
    a call returns them."""

    cache: KVCache
    pos: torch.Tensor  # (B,) int32: per-row cache length / next write slot
    prev: torch.Tensor  # (B, C+1) int32: last emitted frame
    rep_pen: RepPenWindow  # tokens (B, C, W)
    rng: Union[torch.Generator, RowNoise]  # static: one generator; dynamic: per row
    done: torch.Tensor  # (B,) bool
    samp: RowSampling  # per-row knobs (read by dynamic engines only)


class GenerationResult(NamedTuple):
    tokens: np.ndarray  # (num_codebooks, T): codebook rows only
    semantic: np.ndarray  # (T,): semantic row (vocab ids)
    frames: int
    hit_max: bool
    prefill_s: float
    decode_s: float
    prompt_tokens: int
    hidden: Optional[np.ndarray] = None  # (T, D) float32 slow hiddens if collected


def _bucket_for(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"Prompt length {n} exceeds the largest bucket {buckets[-1]}")


def _fresh_seed() -> int:
    return int(np.random.default_rng().integers(0, 2**31 - 1))


def _set_rows(t: torch.Tensor, row0: int, rows: torch.Tensor) -> torch.Tensor:
    """A copy of t with rows [row0, row0 + len(rows)) replaced."""
    out = t.clone()
    out[row0:row0 + rows.shape[0]] = rows
    return out


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """t (k, ...) with its last row repeated up to n rows."""
    return torch.cat([t, t[-1:].expand(n - t.shape[0], *t.shape[1:])])


def _check_cuda_dtypes(params, dtype) -> None:
    """The CUDA kernels take bfloat16 weights and cache, and int8
    quantized weights {"q": int8, "s": bfloat16}: refuse anything else
    before a first prefill would."""
    bad = []

    def walk(tree, name):
        if is_quantized(tree):
            if tree["q"].dtype != torch.int8:
                bad.append(f"{name}.q ({tree['q'].dtype}, not int8)")
            if tree["s"].dtype != torch.bfloat16:
                bad.append(f"{name}.s ({tree['s'].dtype})")
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{name}.{k}" if name else k)
        elif tree.is_floating_point() and tree.dtype != torch.bfloat16:
            bad.append(f"{name} ({tree.dtype})")

    walk(params, "")
    if dtype != torch.bfloat16 or bad:
        raise ValueError(
            "LMEngine on CUDA: the port's kernels take bfloat16 weights and cache (and int8 "
            f"quantized weights with bfloat16 scales) only; got dtype={dtype}"
            + (f" and weights {', '.join(bad[:4])}" if bad else "")
            + ". Convert with io.convert.dual_ar_params_from_numpy(..., dtype=torch.bfloat16)")


class LMEngine:
    """Owns the (head-gathered) parameters and runs generation. One
    engine per (model, batch size, cache length). Not thread-safe."""

    def __init__(
        self,
        params,
        cfg: DualARConfig,
        token_cfg: TokenConfig,
        lm: WhichLM,
        *,
        batch_size: int = 1,
        cache_len: Optional[int] = None,
        max_frames: int = 2048,
        rep_pen_window: int = SINGLE_STREAM_REP_PEN_WINDOW,
        prompt_buckets=DEFAULT_BUCKETS,
        dtype=torch.bfloat16,
        device="cuda",
        slow_impl: str = "auto",
        fast_frame_impl: str = "auto",
        dynamic_sampling: bool = False,
        dyn_top_k_cap: int = 256,
        quantize_int8: bool = False,
        _params_preprocessed: bool = False,
    ) -> None:
        """_params_preprocessed: `params` is another engine's `params`
        (head gathered, quantized if quantize_int8), shared as it is, as
        the JAX engine's flag of that name does for the pipeline's
        batched engines."""
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            _check_cuda_dtypes(params, dtype)
        if not _params_preprocessed:
            if quantize_int8 and any(is_quantized(v) for st in ("slow", "fast")
                                     for v in params[st].values()):
                raise ValueError("LMEngine(quantize_int8=True): the stacks are quantized already")
            # Gather the LM head down to the audio-legal columns once; the
            # full head is not kept, nor, under int8, the bf16 stacks.
            params = dict(params)
            cols = torch.as_tensor(semantic_head_columns(lm, token_cfg, cfg), dtype=torch.long)
            params["output"] = params["output"][:, cols.to(params["output"].device)].contiguous()
        params = tree_to(params, self.device)
        self.quantize_int8 = quantize_int8
        self.params = (quantize_lm_params(params) if quantize_int8 and not _params_preprocessed
                       else params)
        self.cfg = cfg
        self.token_cfg = token_cfg
        self.lm = lm
        self.batch_size = batch_size
        self.cache_len = cache_len or cfg.max_seq_len
        self.max_frames = max_frames
        self.rep_pen_window = rep_pen_window
        self.prompt_buckets = tuple(
            b for b in prompt_buckets if b <= self.cache_len) or (self.cache_len,)
        self.dtype = dtype
        self.dynamic_sampling = dynamic_sampling
        self.dyn_top_k_cap = int(dyn_top_k_cap)
        self.decode_unroll = 1  # frames per loop step, for the batcher's horizons
        self.rope = rope_tables(cfg, self.device)
        self.noise_layout = NoiseLayout.of(lm, cfg, self.params["output"].shape[1],
                                           self.dyn_top_k_cap)
        on_cuda = self.device.type == "cuda"
        self.use_fused_slow = self._pick(
            "slow_impl", slow_impl,
            fused_slow_step_supported(cfg, self.params, batch_size, self.cache_len),
            on_cuda and (batch_size == 1 or batch_size > PERSISTENT_ROWS))
        # the row kernel's head, padded to whole 16-byte pieces once here
        self.rows_head = (padded_head(self.params["output"])
                          if on_cuda and self.use_fused_slow and batch_size > PERSISTENT_ROWS
                          else None)
        # the persistent kernels' grid sync state, this engine's own
        self.sync_state = decode_stack.new_sync_state(self.device)
        if dynamic_sampling:
            fast_ok = fused_fast_frame_batched_supported(cfg, self.params, batch_size,
                                                         self.dyn_top_k_cap)
        else:
            fast_ok = fused_fast_frame_supported(cfg, self.params, batch_size)
        self.use_fused_fast = self._pick("fast_frame_impl", fast_frame_impl, fast_ok, on_cuda)

    @staticmethod
    def _pick(name: str, impl: str, supported: bool, auto: bool) -> bool:
        """"fused" | "xla" | "auto" -> whether the fused path runs."""
        if impl not in ("auto", "fused", "xla"):
            raise ValueError(f"{name} must be 'auto', 'fused' or 'xla', got {impl!r}")
        if impl == "auto":
            return supported and auto
        if impl == "fused" and not supported:
            raise ValueError(f"{name}='fused': the fused path does not take this "
                             "configuration (batch, head dim, dtype, widths or shared memory)")
        return impl == "fused"

    # -- state ------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> GenState:
        """Fresh state; on dynamic engines row r's stream starts from
        seed + r (admissions reseed their rows)."""
        if seed is None:
            seed = _fresh_seed()
        b, c = self.batch_size, self.cfg.num_codebooks
        dev = self.device
        if self.dynamic_sampling:
            rng = RowNoise(b, int(seed) & 0x7FFFFFFF, dev)
        else:
            rng = torch.Generator(device=dev)
            rng.manual_seed(int(seed) & 0x7FFFFFFF)
        return GenState(
            cache=KVCache.init(self.cfg.n_layer, b, self.cfg.n_local_heads,
                               self.cache_len, self.cfg.head_dim, self.dtype, dev),
            pos=torch.zeros((b,), dtype=torch.int32, device=dev),
            prev=torch.zeros((b, c + 1), dtype=torch.int32, device=dev),
            rep_pen=RepPenWindow.init((b, c), self.rep_pen_window, dev),
            rng=rng,
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
            samp=RowSampling.broadcast(SamplingArgs(), b, dev),
        )

    def rewind(self, state: GenState, length: int) -> GenState:
        """Keep the first `length` cache positions, reset everything else."""
        b, c = self.batch_size, self.cfg.num_codebooks
        dev = self.device
        return state._replace(
            pos=torch.full((b,), length, dtype=torch.int32, device=dev),
            prev=torch.zeros((b, c + 1), dtype=torch.int32, device=dev),
            rep_pen=RepPenWindow.init((b, c), self.rep_pen_window, dev),
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    # -- steps ------------------------------------------------------------

    def _kv_extent_for(self, offset: int, bucket: int) -> int:
        need = min(offset + bucket, self.cache_len)
        for b in self.prompt_buckets:
            if need <= b:
                return b
        return self.cache_len

    def _noise(self, state: GenState, sampling: SamplingArgs,
               rows: Sequence[int]) -> Optional[FrameNoise]:
        """One frame's draws for `rows`: from their own streams (dynamic)
        or from the engine's one generator (static)."""
        if self.dynamic_sampling:
            return state.rng.frame(rows, self.noise_layout)
        return draw_frame_noise(self.lm, self.cfg, sampling, len(rows),
                                self.params["output"].shape[1], state.rng, self.device)

    def _pad(self, prompts: Sequence[np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Right-pad (C+1, S_i) prompts to one bucket: (k, C+1, bucket)
        tokens and (k,) lengths on the device, and the bucket."""
        rows = self.cfg.num_codebooks + 1
        lens = [int(p.shape[-1]) for p in prompts]
        bucket = _bucket_for(max(lens), self.prompt_buckets)
        padded = np.zeros((len(prompts), rows, bucket), np.int32)
        for i, p in enumerate(prompts):
            if p.shape[0] != rows:
                raise ValueError(f"prompt has {p.shape[0]} rows, expected {rows}")
            padded[i, :, :lens[i]] = p
        return (torch.from_numpy(padded).to(self.device),
                torch.tensor(lens, dtype=torch.int32, device=self.device), bucket)

    def _prefill_rows_raw(self, state: GenState, prompts: Sequence[np.ndarray],
                          sampling: SamplingArgs, row0: int, offset: int,
                          samp: Optional[RowSampling]):
        """Prefill right-padded prompts into cache rows [row0, row0 + k)
        at `offset` and sample each row's first frame with `samp`
        (dynamic) or `sampling`. Returns (state, frames (k, C+1),
        is_eos (k,), hidden (k, D)), hidden being the slow hidden state
        the first frames were drawn from.

        Each row is prefilled by a call of its own: cuBLAS picks its
        summation order by a product's shape, so one call over the burst
        would make a row's cache and codes depend on how many rows were
        admitted with it. For the same reason the first frames of a
        dynamic engine's burst are drawn at the engine's whole batch (the
        rows past the burst copies of its last, their draws thrown away):
        on the H100 a 16-row engine drew other codebook tokens for a row
        in a burst of 8 than for the same row alone."""
        tokens, seq_lens, bucket = self._pad(prompts)
        k, c = tokens.shape[0], self.cfg.num_codebooks
        extent = self._kv_extent_for(offset, bucket)
        rows = [slow_prefill(self.params, self.cfg, self.token_cfg, tokens[i:i + 1],
                             seq_lens[i:i + 1], state.cache, offset, self.rope,
                             kv_extent=extent, slot=row0 + i) for i in range(k)]
        logits, hidden = (torch.cat(t) for t in zip(*rows))
        noise = self._noise(state, sampling, range(row0, row0 + k))
        n = self.batch_size if samp is not None else k
        if n > k:
            logits, hidden = _pad_rows(logits, n), _pad_rows(hidden, n)
            noise = FrameNoise(*(_pad_rows(t, n) for t in noise))
            samp = RowSampling(*(_pad_rows(t, n) for t in samp))
        res: FrameResult = generate_frame(
            self.params, self.cfg, self.token_cfg, self.lm, sampling, logits, hidden,
            RepPenWindow.init((n, c), self.rep_pen_window, self.device), None, noise,
            self.rope, samp=samp, dyn_top_k_cap=self.dyn_top_k_cap)
        res = FrameResult(tokens=res.tokens[:k], is_eos=res.is_eos[:k], rep_pen=res.rep_pen)
        hidden = hidden[:k]
        state = state._replace(
            pos=_set_rows(state.pos, row0, offset + seq_lens),
            prev=_set_rows(state.prev, row0, res.tokens),
            rep_pen=RepPenWindow(
                tokens=_set_rows(state.rep_pen.tokens, row0, torch.full(
                    (k, c, self.rep_pen_window), -1, dtype=torch.int32, device=self.device)),
                ptr=state.rep_pen.ptr),
            done=_set_rows(state.done, row0, res.is_eos))
        return state, res.tokens, res.is_eos, hidden

    @torch.inference_mode()
    def prefill(self, state: GenState, prompt: np.ndarray, sampling: SamplingArgs,
                offset: int = 0, seq_lens=None) -> Tuple[GenState, torch.Tensor, torch.Tensor]:
        """Prefill a (C+1, S) prompt (batch-1 engines) or a (B, C+1, S)
        batch at cache position `offset` and sample the first frame of
        every row. seq_lens: the rows' real lengths when they are
        right-padded to a common S. Returns (state, frame (B, C+1),
        is_eos (B,))."""
        return self._prefill_raw(state, prompt, sampling, offset, seq_lens)[:3]

    @torch.inference_mode()
    def _prefill_raw(self, state: GenState, prompt: np.ndarray, sampling: SamplingArgs,
                     offset: int = 0, seq_lens=None):
        """Like prefill(), also returning the slow hidden state (B, D) the
        first frames were drawn from."""
        prompt = np.asarray(prompt)
        if prompt.ndim == 2:
            prompt = prompt[None]
        if prompt.shape[0] != self.batch_size:
            raise ValueError(f"prefill: {prompt.shape[0]} rows, engine batch {self.batch_size}")
        lens = [prompt.shape[2]] * prompt.shape[0] if seq_lens is None else list(seq_lens)
        rows = [p[:, :n] for p, n in zip(prompt, lens)]
        samp = state.samp if self.dynamic_sampling else None
        return self._prefill_rows_raw(state, rows, sampling, 0, offset, samp)

    @torch.inference_mode()
    def prefill_row(self, state: GenState, prompt: np.ndarray, sampling: SamplingArgs,
                    row: int, offset: int = 0, seed: Optional[int] = None
                    ) -> Tuple[GenState, torch.Tensor, torch.Tensor]:
        """Admit one (C+1, S) prompt into row `row` of a shared batch at
        cache position `offset` (rewinding the row there). On dynamic
        engines `sampling` and `seed` (fresh when None) become the row's
        knobs and stream. Returns (state, first frame (C+1,), is_eos ())
        as device tensors."""
        prompt = np.asarray(prompt)
        if prompt.ndim == 3:
            prompt = prompt[0]
        state, frames, eos = self.prefill_rows(state, [prompt], sampling, row, [(sampling, seed)],
                                               offset=offset)
        return state, frames[0], eos[0]

    @torch.inference_mode()
    def prefill_rows(self, state: GenState, prompts: Sequence[np.ndarray],
                     sampling: SamplingArgs, row0: int, per_row=None, offset: int = 0
                     ) -> Tuple[GenState, torch.Tensor, torch.Tensor]:
        """Admit a burst of (C+1, S_i) prompts into contiguous rows
        [row0, row0 + k), with one first-frame draw for the burst.
        per_row: on dynamic engines each row's (SamplingArgs, seed or
        None); defaults to `sampling` with fresh seeds. Returns (state,
        frames (k, C+1), is_eos (k,)) as device tensors."""
        prompts = [np.asarray(p) for p in prompts]
        k = len(prompts)
        samp = None
        if self.dynamic_sampling:
            per_row = per_row or [(sampling, None)] * k
            for i, (_, seed) in enumerate(per_row):
                state.rng.reseed(row0 + i, _fresh_seed() if seed is None else int(seed))
            vecs = torch.from_numpy(np.stack([RowSampling.row_vector(s) for s, _ in per_row]))
            state = state._replace(samp=state.samp.set_rows(row0, vecs))
            samp = RowSampling.from_vectors(vecs.to(self.device))
        return self._prefill_rows_raw(state, prompts, sampling, row0, offset, samp)[:3]

    @torch.inference_mode()
    def decode_step(self, state: GenState, sampling: SamplingArgs
                    ) -> Tuple[GenState, torch.Tensor]:
        """One frame for every row: slow step, semantic draw, fast
        codebook loop. A row that is done keeps emitting EOS frames and
        stops advancing."""
        return self._step(state, sampling)[:2]

    @torch.inference_mode()
    def _step(self, state: GenState, sampling: SamplingArgs):
        """decode_step, also returning the slow hidden state (B, D) the
        frame was drawn from."""
        noise = self._noise(state, sampling, range(self.batch_size))
        if self.use_fused_slow:
            x0 = embed_tokens(self.params, self.cfg, self.token_cfg,
                              state.prev[:, :, None])[:, 0, :]
            logits, hidden = fused_slow_step(
                self.params, self.cfg, x0, state.pos, state.cache.k, state.cache.v,
                self.rope, head_rows=self.rows_head, sync=self.sync_state)
        else:
            logits, hidden = slow_decode_step(
                self.params, self.cfg, self.token_cfg, state.prev, state.cache,
                state.pos, self.rope)
        res = generate_frame(
            self.params, self.cfg, self.token_cfg, self.lm, sampling, logits, hidden,
            state.rep_pen, state.prev, noise, self.rope, use_fused_fast=self.use_fused_fast,
            samp=state.samp if self.dynamic_sampling else None,
            dyn_top_k_cap=self.dyn_top_k_cap, sync_state=self.sync_state)
        eos_frame = torch.zeros_like(state.prev)
        eos_frame[:, 0] = self.token_cfg.im_end_id
        frame = torch.where(state.done[:, None], eos_frame, res.tokens)
        # A row decoding past its budget (a batcher's speculative tick, the
        # last tick's frames past the budget) stays at the last cache slot,
        # where the JAX engine's gathers and updates clamp; a row within
        # its budget never gets there.
        state = state._replace(
            pos=torch.where(state.done, state.pos,
                            torch.clamp(state.pos + 1, max=self.cache_len - 1)),
            prev=frame, rep_pen=res.rep_pen, done=state.done | res.is_eos)
        return state, frame, hidden

    @torch.inference_mode()
    def decode_chunk(self, state: GenState, sampling: SamplingArgs, horizon: int,
                     max_steps: Optional[int] = None):
        """Decode up to `horizon` frames (at most max_steps) for the whole
        batch without reading the device. Returns (state, out (horizon,
        B, C+1), valid (horizon, B), steps), all on the device.

        valid[i, b] is false where row b was done before frame i or emits
        <|im_end|> there. steps is where the JAX decode loop stops: at
        max_steps, or after the frame in which every row is done (0 when
        all are done already). The frames past `steps` still run, and are
        invalid EOS frames; the carried state is the JAX loop's up to
        those dead frames' positions, which do not move."""
        n = horizon if max_steps is None else max(min(max_steps, horizon), 0)
        b, c = self.batch_size, self.cfg.num_codebooks
        dev = self.device
        out = torch.zeros((horizon, b, c + 1), dtype=torch.int32, device=dev)
        valid = torch.zeros((horizon, b), dtype=torch.bool, device=dev)
        all_done = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
        all_done[0] = state.done.all()
        for i in range(n):
            was_done = state.done
            state, frame = self.decode_step(state, sampling)
            out[i] = frame
            valid[i] = ~was_done & (frame[:, 0] != self.token_cfg.im_end_id)
            all_done[i + 1] = state.done.all()
        steps = torch.where(all_done.any(), torch.argmax(all_done.to(torch.uint8)),
                            torch.full((), n, dtype=torch.int64, device=dev))
        return state, out, valid, steps

    # -- generation -------------------------------------------------------

    def generate(self, prompt: np.ndarray, *, max_new_tokens: int = 1024,
                 sampling: Optional[SamplingArgs] = None,
                 state: Optional[GenState] = None, conditioning_offset: int = 0,
                 seed: Optional[int] = None,
                 collect_hidden: bool = False) -> Tuple[GenerationResult, GenState]:
        """Blocking generation for one (C+1, S) prompt on a batch-1 engine.
        Returns codebook rows (C, T) and the semantic row; the first frame
        is always kept, even if it is EOS. collect_hidden: also return
        the slow hidden state each kept frame was drawn from, (T, D)
        float32."""
        if self.batch_size != 1:
            raise ValueError("generate() drives batch-1 engines; use generate_batch")
        sampling = sampling or SamplingArgs()
        if state is None:
            state = self.init_state(seed)
        if self.dynamic_sampling:
            state = state._replace(samp=RowSampling.broadcast(sampling, 1, self.device))
        prompt = np.asarray(prompt)
        prompt_len = prompt.shape[-1]
        t0 = time.perf_counter()
        state, first, _, first_hidden = self._prefill_raw(state, prompt, sampling,
                                                          offset=conditioning_offset)
        frames: List[torch.Tensor] = [first[0]]
        hiddens: List[torch.Tensor] = [first_hidden[0]]
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
            state, frame, hidden = self._step(state, sampling)
            steps += 1
            done = bool(state.done[0])  # one host sync per frame
            if int(frame[0, 0]) != self.token_cfg.im_end_id:
                frames.append(frame[0])
                hiddens.append(hidden[0])
        stacked = torch.stack(frames, dim=1).cpu().numpy()  # (C+1, T)
        hidden = torch.stack(hiddens).float().cpu().numpy() if collect_hidden else None
        decode_s = time.perf_counter() - t1
        result = GenerationResult(
            tokens=stacked[1:],
            semantic=stacked[0],
            frames=stacked.shape[1],
            hit_max=steps >= budget > 0 and not done,
            prefill_s=prefill_s,
            decode_s=decode_s,
            prompt_tokens=prompt_len,
            hidden=hidden,
        )
        return result, state

    def generate_batch(self, prompts: Sequence[np.ndarray], *, max_new_tokens: int = 1024,
                       sampling: Optional[SamplingArgs] = None,
                       seed: Optional[int] = None) -> List[GenerationResult]:
        """Blocking generation for a fixed batch of ragged (C+1, S_i)
        prompts, len(prompts) == batch_size: rows are right-padded and
        keep their own positions; a row that ends keeps emitting EOS
        frames without advancing. One prefill, one decode chunk of the
        whole budget, one fetch. Returns one GenerationResult per row."""
        b = self.batch_size
        if len(prompts) != b:
            raise ValueError(f"generate_batch: {len(prompts)} prompts, engine batch {b}")
        sampling = sampling or SamplingArgs()
        state = self.init_state(seed)
        if self.dynamic_sampling:
            state = state._replace(samp=RowSampling.broadcast(sampling, b, self.device))
        prompts = [np.asarray(p) for p in prompts]
        lens = [int(p.shape[-1]) for p in prompts]
        t0 = time.perf_counter()
        with torch.inference_mode():
            samp = state.samp if self.dynamic_sampling else None
            state, first, _, _ = self._prefill_rows_raw(state, prompts, sampling, 0, 0, samp)
        prefill_s = time.perf_counter() - t0
        budget = max(min(max_new_tokens - 1, self.max_frames, self.cache_len - max(lens) - 1), 0)
        t1 = time.perf_counter()
        state, out, valid, steps = self.decode_chunk(state, sampling, budget)
        out, valid, steps, done, first = (t.cpu().numpy() for t in (
            out, valid, steps, state.done, first))
        steps = int(steps)
        decode_s = time.perf_counter() - t1
        results = []
        for r in range(b):
            kept = [out[i, r] for i in range(steps) if valid[i, r]]
            row = np.stack([first[r]] + kept, axis=1)  # (C+1, T_r)
            results.append(GenerationResult(
                tokens=row[1:], semantic=row[0], frames=row.shape[1],
                hit_max=steps >= budget > 0 and not bool(done[r]),
                prefill_s=prefill_s, decode_s=decode_s, prompt_tokens=lens[r]))
        return results

    def warmup(self, sampling: Optional[SamplingArgs] = None, buckets=None,
               conditioning_lens=(0,), chunk_horizons=()) -> None:
        """Build the kernels and run each path once, on scratch states, so
        the first request pays no first-call cost: a prefill of each of
        `buckets` (default: the smallest prompt bucket; PyTorch builds no
        program per shape, so one prefill builds the path) at each
        conditioning offset (each distinct (bucket, attention extent)
        once; offsets whose bucket does not fit the cache are skipped),
        one decode frame, and one decode chunk of each of chunk_horizons."""
        sampling = sampling or SamplingArgs()
        prompt_rows = self.cfg.num_codebooks + 1
        seen = set()
        for bucket in buckets or self.prompt_buckets[:1]:
            for cond in conditioning_lens:
                key = (bucket, self._kv_extent_for(cond, bucket))
                if cond + bucket > self.cache_len or key in seen:
                    continue
                seen.add(key)
                t0 = time.perf_counter()
                prompt = np.zeros((prompt_rows, bucket), np.int32)
                self.prefill_row(self.init_state(seed=0), prompt, sampling, 0, offset=cond)
                self._sync()
                logger.info("warmup prefill bucket %d (offset %d): %.2fs", bucket, cond,
                            time.perf_counter() - t0)
        for horizon in (1, *chunk_horizons):
            t0 = time.perf_counter()
            self.decode_chunk(self.init_state(seed=0), sampling, horizon)
            self._sync()
            logger.info("warmup decode chunk horizon %d: %.2fs", horizon,
                        time.perf_counter() - t0)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
