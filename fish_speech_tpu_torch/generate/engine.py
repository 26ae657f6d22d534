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
plain versions.

The decode loop, the counterpart of the JAX engine's compiled while loop
(`_get_decode_loop`, engine.py:585-711), is one function of static shapes,
`_decode_body`: `horizon` frames in iterations of `decode_unroll` frames
("auto" = 1, as in JAX), with JAX's tail masking (a frame at or past
max_steps writes nothing and changes no state the caller reads), and
`steps` where the JAX loop stops. `decode_impl` says how it runs:

* "graph": `generate/graph.py` captures it into a CUDA graph per
  (sampling key, horizon, collect_hidden, masked) and replays it, max_steps
  an operand of the replay (so a budget-cut chunk captures nothing new),
  copying the
  state in and out, the noise streams handed over through PyTorch's
  graph-safe generator state, so a seeded request's codes are the eager
  loop's; a failed capture or replay raises;
* "eager": the same function frame by frame from Python (the CPU, a
  sharded engine, the card's A/B);
* "auto" (default): "graph" on CUDA for an unsharded engine, "eager"
  otherwise (gloo's collectives under a mesh are not captured).

A call runs the frames of the JAX loop's iterations up to max_steps,
min(max_steps, horizon) rounded up to the unroll, with no early exit: the
eager loop runs them, a graph replays its whole horizon with the frames
at or past max_steps masked and then sets the noise streams where those
frames leave them, so both modes advance the streams alike (by JAX's
frame count for a budget-cut chunk). Where JAX's loop stops at the first
all-done iteration, the frames past it run here too, all invalid: they
cost card time and advance the noise streams beyond where JAX's would
be for a `rewind` continuation.

`quantize_int8=True` quantizes the slow and fast matmul stacks after the
head gather (`ops/quant.py`, as the JAX engine does at engine.py:154-167)
and keeps no bf16 copy of them; a tree that is quantized already (a JAX
tree through `io.convert`) runs the same way without the flag. Under tp
the engine takes a shard of a tree quantized whole
(`TTSPipeline.load(..., quantize_int8=True, mesh=)` makes it) and refuses
a bf16 shard: a row-split weight's scales need its whole column. The fused
kernels take the int8 stacks as they are; the unfused paths convert each
int8 weight to the activation dtype at every product.

* Prompts are right-padded to a bucket, and each row is prefilled by a
  call of its own (see `_prefill_rows_raw`); the attention read extent is
  the smallest bucket covering offset + bucket.
* `generate` decodes in chunks of 16 frames (`chunk_plan`; the last one
  budget-cut), each issued before the previous one is read, and reads the
  device once a chunk through copies queued behind it (`device.Fetch`),
  plus once for the first frame; it stops issuing once a read shows the
  row done, so an utterance that ends at EOS runs at most 31 frames past
  it (the rest of its chunk and the one issued behind it).
  `generate_batch` issues the same chunks back to back and reads once.
  With profile=False (default) nothing waits between the prefill and
  the first chunk; profile=True syncs after the prefill for the true
  phase split (the JAX flag; the CLI passes it). `decode_chunk` never
  reads the device: outputs, valid flags and `steps` stay on the card
  until the caller fetches them.
* `_prefill_raw` and `generate(collect_hidden=True)` also give the slow
  hidden state each frame was drawn from; `warmup` runs the smallest
  prompt bucket (or the buckets, conditioning offsets and decode-chunk
  horizons it is given) once.
* `rewind` keeps a conditioning prefix: only the position counter moves.

Under a (dp, tp) mesh (`mesh=`, `parallel/`) the engine is one rank's:
its parameters are the rank's shard (`parallel.mesh.shard_lm_params`),
its cache holds the rank's KV heads, and its state the rank's rows, those
of its dp block where dp divides the batch, else all of them (as the
JAX engine keeps the batch-1 engine whole under dp). Arguments name rows
of the whole batch; results are the rank's rows. `parallel.driver`
gathers them, and drives every rank's engine from one. On a mesh of more
than one rank the fused slow step and fast frame are off, as in JAX
(engine.py:215-262), and an explicit "fused" raises; decode and prefill
attention run their kernels on the rank's own heads (the JAX engine
turns flash prefill off under a mesh only because its shard_map covers
the decode kernel alone). Static engines draw every row's noise on every
rank and keep their own; a dynamic row's stream is seeded from its row
in the whole batch; `decode_chunk`'s "all rows done" marker is reduced
over dp.
"""

from __future__ import annotations

import logging
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fish_speech_tpu_torch.config import DualARConfig, TokenConfig, WhichLM
from fish_speech_tpu_torch.device import Fetch, resolve_device, tree_to
from fish_speech_tpu_torch.generate.frame import (
    FrameNoise,
    FrameResult,
    NoiseLayout,
    RowNoise,
    draw_frame_noise,
    generate_frame,
    pushes_rep_pen,
    semantic_head_columns,
)
from fish_speech_tpu_torch.generate.graph import DecodeGraphs
from fish_speech_tpu_torch.models.dual_ar import (
    KVCache,
    embed_tokens,
    local_heads,
    rope_tables,
    slow_decode_step,
    slow_head,
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
from fish_speech_tpu_torch.parallel.distributed import coords, local_rows
from fish_speech_tpu_torch.parallel.mesh import TensorParallel, split_block

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
# frames of a generate() chunk: a run that ends at EOS runs up to twice this
# less one frame past it (the rest of its chunk and the one issued behind it)
GENERATE_CHUNK = 16

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
        decode_unroll: Union[str, int] = "auto",
        decode_impl: str = "auto",
        mesh=None,
        _params_preprocessed: bool = False,
    ) -> None:
        """mesh: a (dp, tp) DeviceMesh (`parallel.distributed.make_mesh`),
        with `params` this rank's shard; every rank of the mesh builds
        its engine at the same point (under tp the head gather is a
        collective). _params_preprocessed: `params` is another engine's
        `params` (head gathered, quantized if quantize_int8), shared as
        it is, as the JAX engine's flag of that name does for the
        pipeline's batched engines.

        decode_unroll: frames a decode-loop iteration runs, "auto" (1,
        as the JAX engine's auto) or an int >= 1; decode_chunk horizons
        are multiples of it. decode_impl: "graph" (the decode loop as
        CUDA graphs, `generate/graph.py`), "eager" (frame by frame from
        Python) or "auto" (graphs on CUDA for an unsharded engine, eager
        otherwise); "graph" on the CPU or under a mesh of more than one
        rank raises."""
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            _check_cuda_dtypes(params, dtype)
        self.mesh = mesh
        self.tp = TensorParallel.of(mesh)
        sharded = coords(mesh).size > 1
        quantized = any(is_quantized(v) for st in ("slow", "fast") for v in params[st].values())
        if quantize_int8 and self.tp is not None and not _params_preprocessed and not quantized:
            raise ValueError("LMEngine(quantize_int8=True) on a bf16 tp shard: a row-split "
                             "weight's scales need its whole column, so the whole tree is "
                             "quantized before it is sharded, as TTSPipeline.load(..., "
                             "quantize_int8=True, mesh=) does; pass that quantized shard")
        cols = semantic_head_columns(lm, token_cfg, cfg)
        self.head_width = len(cols)  # the gathered head's columns (split under tp)
        if not _params_preprocessed:
            if quantize_int8 and quantized and self.tp is None:
                raise ValueError("LMEngine(quantize_int8=True): the stacks are quantized already")
            # Gather the LM head down to the audio-legal columns once; the
            # full head is not kept, nor, under int8, the bf16 stacks.
            # Under tp the vocab-split head is gathered whole, then split
            # again by columns, padded to a multiple of tp.
            params = dict(params)
            cols = torch.as_tensor(cols, dtype=torch.long, device=params["output"].device)
            if self.tp is None:
                params["output"] = params["output"][:, cols].contiguous()
            else:
                head = self.tp.gather_columns(params["output"], cols)
                params["output"] = split_block(head, 1, self.tp.rank, self.tp.size).contiguous()
        params = tree_to(params, self.device)
        self.quantize_int8 = quantize_int8
        # a tp shard comes quantized (TTSPipeline.load quantizes the whole tree)
        self.params = (quantize_lm_params(params)
                       if quantize_int8 and not _params_preprocessed and not quantized
                       else params)
        self.cfg = cfg
        self.token_cfg = token_cfg
        self.lm = lm
        self.batch_size = batch_size  # rows of the whole batch
        self.rows = local_rows(batch_size, mesh)  # this rank's [lo, hi)
        self.local_batch = self.rows[1] - self.rows[0]
        self.rows_split = self.local_batch < batch_size
        self.cache_len = cache_len or cfg.max_seq_len
        self.max_frames = max_frames
        self.rep_pen_window = rep_pen_window
        self.prompt_buckets = tuple(
            b for b in prompt_buckets if b <= self.cache_len) or (self.cache_len,)
        self.dtype = dtype
        self.dynamic_sampling = dynamic_sampling
        self.dyn_top_k_cap = int(dyn_top_k_cap)
        if decode_unroll == "auto":
            decode_unroll = 1  # the JAX engine's auto: measured neutral there
        if isinstance(decode_unroll, str) or int(decode_unroll) < 1:
            raise ValueError(f"decode_unroll must be 'auto' or an int >= 1, got {decode_unroll!r}")
        self.decode_unroll = int(decode_unroll)  # frames a loop iteration runs
        # a generate() chunk's horizon, a multiple of the unroll
        self.generate_chunk = -(-GENERATE_CHUNK // self.decode_unroll) * self.decode_unroll
        self.rope = rope_tables(cfg, self.device)
        self.noise_layout = NoiseLayout.of(lm, cfg, self.head_width, self.dyn_top_k_cap)
        on_cuda = self.device.type == "cuda"
        for name, impl in (("slow_impl", slow_impl), ("fast_frame_impl", fast_frame_impl)):
            if sharded and impl == "fused":
                raise ValueError(f"{name}='fused' on a mesh of more than one rank: the fused "
                                 "kernels run unsharded only, as in JAX; use 'xla' or 'auto'")
        self.use_fused_slow = not sharded and self._pick(
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
        self.use_fused_fast = not sharded and self._pick("fast_frame_impl", fast_frame_impl,
                                                          fast_ok, on_cuda)
        if decode_impl not in ("auto", "graph", "eager"):
            raise ValueError(f"decode_impl must be 'auto', 'graph' or 'eager', got {decode_impl!r}")
        if decode_impl == "graph" and (not on_cuda or sharded):
            raise ValueError("decode_impl='graph' captures CUDA graphs of an unsharded engine on "
                             "CUDA: the CPU has none, and gloo's collectives under a mesh are "
                             "not captured; use 'eager' or 'auto'")
        self.decode_impl = decode_impl
        # the captured decode loop, or None where the loop runs eagerly
        self.graphs = (DecodeGraphs(self) if decode_impl == "graph"
                       or (decode_impl == "auto" and on_cuda and not sharded) else None)

    def sibling(self, **kwargs) -> "LMEngine":
        """A new engine sharing these weights as they are (head gathered,
        quantized), with this one's cache length, frame budget, prompt
        buckets, dtype, device, quantization, decode loop and mesh, and
        `kwargs` for the rest (batch_size, rep_pen_window, dynamic_sampling, ...)."""
        base = dict(cache_len=self.cache_len, max_frames=self.max_frames,
                    prompt_buckets=self.prompt_buckets, dtype=self.dtype, device=self.device,
                    quantize_int8=self.quantize_int8, decode_unroll=self.decode_unroll,
                    decode_impl=self.decode_impl, mesh=self.mesh)
        return LMEngine(self.params, self.cfg, self.token_cfg, self.lm, **{**base, **kwargs},
                        _params_preprocessed=True)

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
        """Fresh state of this rank's rows; on dynamic engines batch row r's
        stream starts from seed + r (admissions reseed their rows)."""
        if seed is None:
            seed = _fresh_seed()
        b, c = self.local_batch, self.cfg.num_codebooks
        dev = self.device
        if self.dynamic_sampling:
            rng = RowNoise(b, int(seed) & 0x7FFFFFFF, dev, row0=self.rows[0])
        else:
            rng = torch.Generator(device=dev)
            rng.manual_seed(int(seed) & 0x7FFFFFFF)
        return GenState(
            cache=KVCache.init(self.cfg.n_layer, b, local_heads(self.cfg, self.tp)[1],
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
        b, c = self.local_batch, self.cfg.num_codebooks
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

    def with_sampling(self, state: GenState, sampling: SamplingArgs) -> GenState:
        """The state with every row's knobs set to `sampling` (dynamic
        engines read them)."""
        return state._replace(samp=RowSampling.broadcast(sampling, self.local_batch,
                                                         self.device))

    def with_rng(self, state: GenState, rng) -> GenState:
        """The state with the noise streams of the whole batch replaced by
        a `generate.frame.ReplayRowNoise`'s: this rank keeps its rows'."""
        return state._replace(rng=rng.rows(*self.rows, device=self.device))

    def mine(self, row0: int, k: int) -> range:
        """The positions in a burst of batch rows [row0, row0 + k) that
        this rank holds."""
        lo, hi = self.rows
        a, b = max(row0, lo) - row0, min(row0 + k, hi) - row0
        return range(a, max(a, b))

    def _noise(self, state: GenState, sampling: SamplingArgs,
               rows: range) -> Optional[FrameNoise]:
        """One frame's draws for batch rows `rows`, of those this rank
        holds: from their own streams (dynamic), or from the engine's one
        generator (static), which draws every row of `rows` on every
        rank, so its stream does not depend on the split."""
        row0, k = rows.start, len(rows)
        mine = self.mine(row0, k)
        if self.dynamic_sampling:
            return (state.rng.frame([row0 + i - self.rows[0] for i in mine], self.noise_layout)
                    if mine else None)
        noise = draw_frame_noise(self.lm, self.cfg, sampling, k, self.head_width, state.rng,
                                 self.device)
        if noise is None or len(mine) == k:
            return noise
        cut = slice(mine.start, mine.stop)
        return FrameNoise(semantic=noise.semantic[cut],
                          codebooks=None if noise.codebooks is None
                          else [t[cut] for t in noise.codebooks])

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The gathered head's logits (B, W) float32 of slow hidden states
        (B, D), as the slow step computes them."""
        return slow_head(self.params, self.cfg, hidden, self.tp, self.head_width)

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
        """Prefill right-padded prompts into batch rows [row0, row0 + k)
        at `offset` and sample each row's first frame with `samp`
        (dynamic: the knobs of the burst's rows this rank holds) or
        `sampling`. Returns (state, frames, is_eos, hidden) of the
        burst's rows this rank holds (`mine`): (k', C+1), (k',), (k', D),
        hidden being the slow hidden state the first frames were drawn
        from.

        Each row is prefilled by a call of its own: cuBLAS picks its
        summation order by a product's shape, so one call over the burst
        would make a row's cache and codes depend on how many rows were
        admitted with it. For the same reason the first frames of a
        dynamic engine's burst are drawn at the engine's whole batch (the
        rows past the burst copies of its last, their draws thrown away):
        on the H100 a 16-row engine drew other codebook tokens for a row
        in a burst of 8 than for the same row alone."""
        # the whole burst is padded on every rank: one bucket for its rows,
        # and a bad prompt raises on every rank alike
        tokens, seq_lens, bucket = self._pad(prompts)
        noise = self._noise(state, sampling, range(row0, row0 + len(prompts)))
        mine = self.mine(row0, len(prompts))
        c = self.cfg.num_codebooks
        if not mine:
            empty = torch.zeros((0, c + 1), dtype=torch.int32, device=self.device)
            return (state, empty, torch.zeros((0,), dtype=torch.bool, device=self.device),
                    torch.zeros((0, self.cfg.dim), dtype=self.dtype, device=self.device))
        slot0 = row0 + mine.start - self.rows[0]  # the first local cache row
        tokens, seq_lens = tokens[mine.start:mine.stop], seq_lens[mine.start:mine.stop]
        k = tokens.shape[0]
        extent = self._kv_extent_for(offset, bucket)
        rows = [slow_prefill(self.params, self.cfg, self.token_cfg, tokens[i:i + 1],
                             seq_lens[i:i + 1], state.cache, offset, self.rope,
                             kv_extent=extent, slot=slot0 + i, tp=self.tp,
                             head_width=self.head_width) for i in range(k)]
        logits, hidden = (torch.cat(t) for t in zip(*rows))
        n = self.local_batch if samp is not None else k
        if n > k:
            logits, hidden = _pad_rows(logits, n), _pad_rows(hidden, n)
            noise = FrameNoise(*(_pad_rows(t, n) for t in noise))
            samp = RowSampling(*(_pad_rows(t, n) for t in samp))
        res: FrameResult = generate_frame(
            self.params, self.cfg, self.token_cfg, self.lm, sampling, logits, hidden,
            RepPenWindow.init((n, c), self.rep_pen_window, self.device), None, noise,
            self.rope, samp=samp, dyn_top_k_cap=self.dyn_top_k_cap, tp=self.tp)
        res = FrameResult(tokens=res.tokens[:k], is_eos=res.is_eos[:k], rep_pen=res.rep_pen)
        hidden = hidden[:k]
        state = state._replace(
            pos=_set_rows(state.pos, slot0, offset + seq_lens),
            prev=_set_rows(state.prev, slot0, res.tokens),
            rep_pen=RepPenWindow(
                tokens=_set_rows(state.rep_pen.tokens, slot0, torch.full(
                    (k, c, self.rep_pen_window), -1, dtype=torch.int32, device=self.device)),
                ptr=state.rep_pen.ptr),
            done=_set_rows(state.done, slot0, res.is_eos))
        return state, res.tokens, res.is_eos, hidden

    @torch.inference_mode()
    def prefill(self, state: GenState, prompt: np.ndarray, sampling: SamplingArgs,
                offset: int = 0, seq_lens=None) -> Tuple[GenState, torch.Tensor, torch.Tensor]:
        """Prefill a (C+1, S) prompt (batch-1 engines) or a (B, C+1, S)
        batch at cache position `offset` and sample the first frame of
        every row. seq_lens: the rows' real lengths when they are
        right-padded to a common S. Returns (state, frame (B, C+1),
        is_eos (B,)) of this rank's rows."""
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
        frames (k, C+1), is_eos (k,)) as device tensors, of the burst's
        rows this rank holds (`mine`)."""
        prompts = [np.asarray(p) for p in prompts]
        k = len(prompts)
        samp = None
        if self.dynamic_sampling:
            per_row = per_row or [(sampling, None)] * k
            mine = self.mine(row0, k)
            for i in mine:
                seed = per_row[i][1]
                state.rng.reseed(row0 + i - self.rows[0],
                                 _fresh_seed() if seed is None else int(seed))
            vecs = torch.from_numpy(np.array([RowSampling.row_vector(per_row[i][0])
                                              for i in mine], np.float32).reshape(len(mine), 4))
            state = state._replace(samp=state.samp.set_rows(row0 + mine.start - self.rows[0],
                                                            vecs))
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
                state.pos, self.rope, tp=self.tp, head_width=self.head_width)
        res = generate_frame(
            self.params, self.cfg, self.token_cfg, self.lm, sampling, logits, hidden,
            state.rep_pen, state.prev, noise, self.rope, use_fused_fast=self.use_fused_fast,
            samp=state.samp if self.dynamic_sampling else None,
            dyn_top_k_cap=self.dyn_top_k_cap, sync_state=self.sync_state, tp=self.tp)
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

    def _skey(self, sampling: SamplingArgs):
        """The sampling's part of a captured loop's key: dynamic engines
        read every knob from GenState.samp, so one loop serves them all
        (the JAX engine's `_skey`)."""
        return None if self.dynamic_sampling else sampling

    def _decode_body(self, state: GenState, sampling: SamplingArgs, horizon: int,
                     limit: torch.Tensor, collect_hidden: bool, masked: bool):
        """The decode loop's work, the same for the eager loop and the CUDA
        graph that captures it (`generate/graph.py`): `horizon` frames, in
        iterations of decode_unroll, of which the first `limit` (a () int64
        tensor on the device, the JAX loop's max_steps) count. masked:
        whether a frame can lie at or past the limit (a tail sub-step of
        the last iteration); such a frame writes no out/valid/hidden, and
        pos, prev, the rep-pen tokens and done keep their values (only the
        noise streams advance; a static rep-pen window's ptr is set by
        `_decode`). Returns (state, out (horizon, B, C+1), valid (horizon,
        B), steps, hidden (horizon, B, D) float32 or None).

        steps is where the JAX loop stops (engine.py:585-711): at the
        first multiple of the unroll at which every row of the whole batch
        is done or the limit is reached, clamped to the limit. The frames'
        outputs are stacked once a chunk, not written frame by frame."""
        dev = self.device
        frames, dones, hiddens = [], [state.done], []
        for i in range(horizon):
            was = state
            state, frame, hidden = self._step(state, sampling)
            if masked:
                keep = limit > i
                state = state._replace(
                    pos=torch.where(keep, state.pos, was.pos),
                    prev=torch.where(keep, state.prev, was.prev),
                    rep_pen=state.rep_pen._replace(
                        tokens=torch.where(keep, state.rep_pen.tokens, was.rep_pen.tokens)),
                    done=torch.where(keep, state.done, was.done))
            frames.append(frame)
            dones.append(state.done)
            hiddens.append(hidden)
        out = torch.stack(frames)
        done = torch.stack(dones)  # (horizon + 1, B): before each frame, then after the last
        valid = ~done[:-1] & (out[:, :, 0] != self.token_cfg.im_end_id)
        hid = torch.stack(hiddens).float() if collect_hidden else None
        if masked:
            live = torch.arange(horizon, device=dev)[:, None] < limit
            valid &= live
            out = torch.where(live[..., None], out, 0)
            hid = None if hid is None else torch.where(live[..., None], hid, 0.0)
        all_done = done.all(dim=1)
        if self.rows_split:  # every dp rank's rows done: no rank has one left
            left = (~all_done).to(torch.int64)
            torch.distributed.all_reduce(left, group=self.mesh.get_group("dp"))
            all_done = left == 0
        u = self.decode_unroll
        stops = all_done[::u] | (torch.arange(0, horizon + 1, u, device=dev) >= limit)
        steps = torch.minimum(torch.argmax(stops.to(torch.uint8)) * u, limit)
        return state, out, valid, steps, hid

    @torch.inference_mode()
    def _decode(self, state: GenState, sampling: SamplingArgs, horizon: int,
                max_steps: Optional[int] = None, collect_hidden: bool = False):
        """decode_chunk, also returning the hidden trace (horizon, B, D)
        float32 where collect_hidden (else None). The noise streams advance
        by the frames of the JAX loop's iterations up to max_steps, run =
        min(max_steps, horizon) rounded up to the unroll: the eager loop
        runs those frames; where the engine has graphs (`self.graphs`), a
        replay of the captured loop of the whole horizon (max_steps its
        operand, the frames past it masked) stands for them. The outputs
        past `run` are zeros."""
        u = self.decode_unroll
        if horizon % u:
            raise ValueError(f"decode_chunk horizon {horizon} must be a multiple of "
                             f"decode_unroll={u}: the carried state would run ahead of the "
                             "reported frames")
        n = horizon if max_steps is None else max(min(max_steps, horizon), 0)
        run = -(-n // u) * u
        ptr = state.rep_pen.ptr
        b, c, dev = self.local_batch, self.cfg.num_codebooks, self.device
        if run == 0:  # no frame: nothing to run or capture
            out = torch.zeros((0, b, c + 1), dtype=torch.int32, device=dev)
            valid = torch.zeros((0, b), dtype=torch.bool, device=dev)
            steps = torch.zeros((), dtype=torch.int64, device=dev)
            hid = (torch.zeros((0, b, self.cfg.dim), dtype=torch.float32, device=dev)
                   if collect_hidden else None)
        elif self.graphs is not None:
            state, out, valid, steps, hid = self.graphs.run(state, sampling, horizon, n, run,
                                                            collect_hidden)
        else:
            limit = torch.full((), n, dtype=torch.int64, device=dev)
            state, out, valid, steps, hid = self._decode_body(state, sampling, run, limit,
                                                              collect_hidden, n < run)
        if out.shape[0] < horizon:
            pad = horizon - out.shape[0]
            out = torch.cat([out, out.new_zeros((pad, b, c + 1))])
            valid = torch.cat([valid, valid.new_zeros((pad, b))])
            hid = None if hid is None else torch.cat([hid, hid.new_zeros((pad, b, hid.shape[2]))])
        # the window took the pushes of the frames that count
        if pushes_rep_pen(self.cfg, sampling, self.dynamic_sampling):
            ptr = (ptr + n) % state.rep_pen.tokens.shape[-1]
        return state._replace(rep_pen=state.rep_pen._replace(ptr=ptr)), out, valid, steps, hid

    def decode_chunk(self, state: GenState, sampling: SamplingArgs, horizon: int,
                     max_steps: Optional[int] = None):
        """Decode up to `horizon` frames (a multiple of decode_unroll), at
        most max_steps (default all), for the whole batch without reading
        the device. Returns (state, out (horizon, B, C+1),
        valid (horizon, B), steps), all on the device. The state given is
        consumed: its cache and noise streams are updated in place.

        valid[i, b] is false where row b was done before frame i, emits
        <|im_end|> there, or i >= max_steps. steps is where the JAX decode
        loop stops: at max_steps, or at the first multiple of the unroll
        at which every row of the whole batch is done (0 when all are done
        already). The frames of the JAX loop's iterations up to
        max_steps run, min(max_steps, horizon) rounded up to the unroll,
        also past `steps` (a CUDA graph runs a fixed number of frames):
        those are invalid, and a tail sub-step past max_steps leaves the
        state as it was but for the noise streams, which advance alike
        under the graph and eagerly. max_steps < horizon serves a
        budget-cut chunk with the horizon's own graph. out and valid are
        this rank's rows."""
        return self._decode(state, sampling, horizon, max_steps)[:4]

    def chunk_plan(self, budget: int) -> List[Tuple[int, int]]:
        """generate()'s chunks for `budget` frames: (horizon, frames that
        count) each, all of horizon generate_chunk, the last one cut to what
        is left (so every budget replays the same two graphs). A run that
        finishes stops issuing one chunk after the chunk that shows it
        done."""
        g = self.generate_chunk
        return [(g, min(g, budget - k)) for k in range(0, budget, g)]

    # -- generation -------------------------------------------------------

    def generate(self, prompt: np.ndarray, *, max_new_tokens: int = 1024,
                 sampling: Optional[SamplingArgs] = None,
                 state: Optional[GenState] = None, conditioning_offset: int = 0,
                 seed: Optional[int] = None, collect_hidden: bool = False,
                 profile: bool = False) -> Tuple[GenerationResult, GenState]:
        """Blocking generation for one (C+1, S) prompt on a batch-1 engine.
        Returns codebook rows (C, T) and the semantic row; the first frame
        is always kept, even if it is EOS. collect_hidden: also return
        the slow hidden state each kept frame was drawn from, (T, D)
        float32.

        The decode runs in chunks (`chunk_plan`), each issued before the
        previous one's outputs are read: they are copied to the host behind
        it (`device.Fetch`), so the host reads the device once a chunk and
        once for the first frame, and stops issuing once a read shows the
        row done. profile=False (default): the first chunk is issued right
        behind the prefill with no sync between them, and prefill_s times
        the prefill's dispatch only; profile=True syncs after the prefill
        for the true phase split (the JAX engine's flag, l.1111-1146; the
        CLI passes it)."""
        if self.batch_size != 1:
            raise ValueError("generate() drives batch-1 engines; use generate_batch")
        sampling = sampling or SamplingArgs()
        if state is None:
            state = self.init_state(seed)
        if self.dynamic_sampling:
            state = self.with_sampling(state, sampling)
        prompt = np.asarray(prompt)
        prompt_len = prompt.shape[-1]
        t0 = time.perf_counter()
        state, first, first_eos, first_hidden = self._prefill_raw(state, prompt, sampling,
                                                                  offset=conditioning_offset)
        head = Fetch([first, first_eos] + ([first_hidden.float()] if collect_hidden else []))
        if profile:
            head = head.get()
        prefill_s = time.perf_counter() - t0

        budget = max(min(
            max_new_tokens - 1,
            self.max_frames,
            self.cache_len - (conditioning_offset + prompt_len) - 1,
        ), 0)
        t1 = time.perf_counter()
        plan = self.chunk_plan(budget)
        pending: List[Fetch] = []

        def issue(state):
            horizon, n = plan[len(pending)]
            state, out, valid, steps, hid = self._decode(state, sampling, horizon, n,
                                                         collect_hidden)
            pending.append(Fetch([out, valid, steps, state.done]
                                 + ([hid] if hid is not None else [])))
            return state

        if plan:
            state = issue(state)
        if not profile:
            head = head.get()
        frames: List[np.ndarray] = [head[0][0]]
        hiddens: List[np.ndarray] = [head[2][0]] if collect_hidden else []
        done = bool(head[1][0])
        steps = 0
        for k in range(len(plan)):
            if k + 1 < len(plan) and not done:
                state = issue(state)  # the next chunk, before this one is read
            out, valid, n, done_k, *hid = pending[k].get()
            n = int(n)
            for i in range(n):
                if valid[i, 0]:
                    frames.append(out[i, 0])
                    if collect_hidden:
                        hiddens.append(hid[0][i, 0])
            steps += n
            done = bool(done_k[0])
            if done:
                break
        stacked = np.stack(frames, axis=1)  # (C+1, T)
        decode_s = time.perf_counter() - t1
        result = GenerationResult(
            tokens=stacked[1:],
            semantic=stacked[0],
            frames=stacked.shape[1],
            hit_max=steps >= budget > 0 and not done,
            prefill_s=prefill_s,
            decode_s=decode_s,
            prompt_tokens=prompt_len,
            hidden=np.stack(hiddens) if collect_hidden else None,
        )
        return result, state

    def generate_batch(self, prompts: Sequence[np.ndarray], *, max_new_tokens: int = 1024,
                       sampling: Optional[SamplingArgs] = None,
                       seed: Optional[int] = None) -> List[GenerationResult]:
        """Blocking generation for a fixed batch of ragged (C+1, S_i)
        prompts, len(prompts) == batch_size: rows are right-padded and
        keep their own positions; a row that ends keeps emitting EOS
        frames without advancing. One prefill, the budget's chunks
        (`chunk_plan`) issued back to back, one fetch. Returns one
        GenerationResult per row."""
        b = self.batch_size
        if len(prompts) != b:
            raise ValueError(f"generate_batch: {len(prompts)} prompts, engine batch {b}")
        if self.rows_split:
            raise ValueError("generate_batch: this engine holds some rows of the batch; "
                             "drive it through parallel.driver")
        sampling = sampling or SamplingArgs()
        state = self.init_state(seed)
        if self.dynamic_sampling:
            state = self.with_sampling(state, sampling)
        prompts = [np.asarray(p) for p in prompts]
        lens = [int(p.shape[-1]) for p in prompts]
        padded = np.zeros((b, self.cfg.num_codebooks + 1, max(lens)), np.int32)
        for r, p in enumerate(prompts):
            padded[r, :, :lens[r]] = p
        t0 = time.perf_counter()
        state, first, _ = self.prefill(state, padded, sampling, seq_lens=lens)
        prefill_s = time.perf_counter() - t0
        budget = max(min(max_new_tokens - 1, self.max_frames, self.cache_len - max(lens) - 1), 0)
        t1 = time.perf_counter()
        outs, valids, steps = [], [], torch.zeros((), dtype=torch.int64, device=self.device)
        for horizon, n in self.chunk_plan(budget):
            # a chunk that starts with every row done stops at 0 steps
            state, out, valid, chunk_steps = self.decode_chunk(state, sampling, horizon, n)
            outs.append(out)
            valids.append(valid)
            steps = steps + chunk_steps
        if not outs:  # no budget
            outs.append(torch.zeros((0, b, self.cfg.num_codebooks + 1), dtype=torch.int32,
                                    device=self.device))
            valids.append(torch.zeros((0, b), dtype=torch.bool, device=self.device))
        out, valid = torch.cat(outs), torch.cat(valids)
        out, valid, steps, done, first = Fetch([out, valid, steps, state.done, first]).get()
        steps = int(steps)
        decode_s = time.perf_counter() - t1
        results = []
        for r in range(b):
            # valid is false past max_steps and for rows done
            kept = [out[i, r] for i in range(out.shape[0]) if valid[i, r]]
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
        one decode frame (decode_unroll frames), and one decode chunk of
        each of chunk_horizons; on an engine with CUDA graphs each chunk
        captures its loop, so no request pays for a capture."""
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
        for horizon in (self.decode_unroll, *chunk_horizons):
            t0 = time.perf_counter()
            self.decode_chunk(self.init_state(seed=0), sampling, horizon)
            self._sync()
            logger.info("warmup decode chunk horizon %d: %.2fs", horizon,
                        time.perf_counter() - t0)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
