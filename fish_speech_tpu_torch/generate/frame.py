"""One DualAR frame: constrained semantic sampling, then the fast
codebook loop. Counterpart of `fish_speech_tpu/generate/frame.py`: the
static-sampling path (one `SamplingArgs` for every row) and the dynamic
one (`samp=`, a `RowSampling` of per-row knobs).

Noise is explicit: a `FrameNoise` carries the draws of the semantic head
and of each codebook step. Tests build it from the JAX package's own
`jax.random` draws; static engines draw it from one `torch.Generator`,
dynamic engines from one generator per row (`RowNoise`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from fish_speech_tpu_torch.config import DualARConfig, TokenConfig, WhichLM
from fish_speech_tpu_torch.models.dual_ar import fast_embed, fast_hist_init, fast_step
from fish_speech_tpu_torch.ops.fast_frame import fused_fast_frame
from fish_speech_tpu_torch.ops.fast_frame_batched import fused_fast_frame_batched
from fish_speech_tpu_torch.ops.sampling import (
    RepPenWindow,
    RowSampling,
    SamplingArgs,
    gumbel_noise,
    legacy_pad_eos_sample,
    sample_top_k_top_p,
    sample_top_k_top_p_dynamic,
    top_k_width,
)


def semantic_head_columns(lm: WhichLM, token_cfg: TokenConfig,
                          cfg: DualARConfig) -> np.ndarray:
    """LM-head columns that constrained semantic sampling can read. The
    engine gathers the output weight down to these once, so the
    per-frame head product reads ~1 MB instead of ~200 MB.
    Fish <= 1.4: [pad, im_end]; 1.5 / DualAR: [im_end] ++ semantic range."""
    if is_legacy(lm):
        return np.array([token_cfg.pad_id, token_cfg.im_end_id], np.int32)
    return np.concatenate([
        np.array([token_cfg.im_end_id], np.int32),
        token_cfg.semantic_start_id + np.arange(cfg.codebook_size, dtype=np.int32),
    ])


def is_legacy(lm: WhichLM) -> bool:
    """Fish <= 1.4: the slow head only chooses PAD or <|im_end|>."""
    return lm in (WhichLM.FISH_1_2, WhichLM.FISH_1_4)


class FrameNoise(NamedTuple):
    """Random draws of one frame.

    semantic: (B, k) Gumbel noise for the semantic head (Fish 1.5 /
    DualAR) or (B,) uniforms for the PAD/EOS draw (Fish <= 1.4).
    codebooks: static frames, one (B, k_cb) Gumbel tensor per codebook
    (None in argmax mode); dynamic frames, one (B, C, k_dyn) tensor."""

    semantic: Optional[torch.Tensor]
    codebooks: Union[List[torch.Tensor], torch.Tensor, None]


def draw_frame_noise(lm: WhichLM, cfg: DualARConfig, sampling: SamplingArgs,
                     batch: int, head_width: int, generator: torch.Generator,
                     device) -> Optional[FrameNoise]:
    """One static frame's draws from `generator`. In argmax mode only
    Fish <= 1.4 draws (its PAD/EOS uniform); otherwise None."""
    if sampling.is_argmax:
        if is_legacy(lm):
            return FrameNoise(
                semantic=torch.rand((batch,), generator=generator, device=device),
                codebooks=None)
        return None
    if is_legacy(lm):
        sem = torch.rand((batch,), generator=generator, device=device)
    else:
        sem = gumbel_noise((batch, top_k_width(sampling.top_k, head_width)),
                           generator, device)
    k_cb = top_k_width(sampling.top_k, cfg.codebook_size)
    return FrameNoise(
        semantic=sem,
        codebooks=[gumbel_noise((batch, k_cb), generator, device)
                   for _ in range(cfg.num_codebooks)],
    )


class NoiseLayout(NamedTuple):
    """Widths of one row's dynamic draws: the semantic head's (0: one
    uniform, Fish <= 1.4), then C codebook steps of k_dyn Gumbel draws."""

    semantic: int
    codebooks: int
    k_dyn: int

    @staticmethod
    def of(lm: WhichLM, cfg: DualARConfig, head_width: int, dyn_top_k_cap: int
           ) -> "NoiseLayout":
        return NoiseLayout(
            semantic=0 if is_legacy(lm) else min(dyn_top_k_cap, head_width),
            codebooks=cfg.num_codebooks,
            k_dyn=min(dyn_top_k_cap, cfg.codebook_size))

    def split(self, u: torch.Tensor) -> FrameNoise:
        """(k, n) uniforms, one row each -> that frame's FrameNoise."""
        k, w = u.shape[0], max(self.semantic, 1)
        tiny = torch.finfo(torch.float32).tiny
        gum = -torch.log(-torch.log(u[:, w:].clamp(min=tiny)))
        sem = u[:, 0] if self.semantic == 0 else -torch.log(-torch.log(
            u[:, :w].clamp(min=tiny)))
        return FrameNoise(semantic=sem,
                          codebooks=gum.reshape(k, self.codebooks, self.k_dyn))

    @property
    def width(self) -> int:
        return max(self.semantic, 1) + self.codebooks * self.k_dyn


class RowNoise:
    """Per-row noise streams of a dynamic engine: one torch.Generator per
    row on the engine's device, as the JAX engine keeps one key chain per
    row, so a seeded row's draws depend only on its own seed and frame
    count, whatever its co-tenants. Tests substitute an object with the
    same two methods that replays JAX's draws (`ReplayRowNoise`).

    row0: the batch row of the first stream, where a rank holds rows
    [row0, row0 + batch) of a batch split over dp; a stream is seeded from
    its row in the whole batch, so the split does not change it."""

    def __init__(self, batch: int, seed: int, device, row0: int = 0) -> None:
        self.device = device
        self.generators = [torch.Generator(device=device) for _ in range(batch)]
        for r, g in enumerate(self.generators):
            g.manual_seed((seed + row0 + r) & 0x7FFFFFFF)

    def rows(self, lo: int, hi: int) -> "RowNoise":
        """The streams of rows [lo, hi), shared with this object."""
        out = RowNoise(0, 0, self.device)
        out.generators = self.generators[lo:hi]
        return out

    def reseed(self, row: int, seed: int) -> None:
        """Restart row `row`'s stream from `seed` (an admission)."""
        self.generators[row].manual_seed(seed & 0x7FFFFFFF)

    def frame(self, rows: Sequence[int], layout: NoiseLayout) -> FrameNoise:
        """The next frame's draws of `rows`: one call per row."""
        u = torch.stack([torch.rand((layout.width,), generator=self.generators[r],
                                    device=self.device) for r in rows])
        return layout.split(u)


class ReplayRowNoise:
    """`RowNoise`'s interface over recorded draws: row r replays
    draws[r], one (semantic, codebooks) pair of arrays a frame ((k,) or
    () and (C, k_dyn)), in order. Tests record another package's draws
    and feed them through it to ranks that import nothing of that
    package. Streams are not reseeded: admissions that reseed raise."""

    def __init__(self, draws, device) -> None:
        self.draws, self.device = draws, device
        self.taken = [0] * len(draws)

    def rows(self, lo: int, hi: int, device=None) -> "ReplayRowNoise":
        """Rows [lo, hi), drawing onto `device` (default: this one's)."""
        return ReplayRowNoise(self.draws[lo:hi], device or self.device)

    def reseed(self, row: int, seed: int) -> None:
        raise NotImplementedError("ReplayRowNoise replays recorded streams; it is not reseeded")

    def frame(self, rows: Sequence[int], layout: NoiseLayout) -> FrameNoise:
        picked = []
        for r in rows:
            picked.append(self.draws[r][self.taken[r]])
            self.taken[r] += 1
        sem, cbs = (torch.from_numpy(np.stack(a)).to(self.device) for a in zip(*picked))
        return FrameNoise(semantic=sem, codebooks=cbs)


def sample_semantic(logits: torch.Tensor, lm: WhichLM, token_cfg: TokenConfig,
                    sampling: SamplingArgs, noise: Optional[torch.Tensor],
                    samp: Optional[RowSampling] = None,
                    dyn_top_k_cap: int = 256) -> torch.Tensor:
    """Constrained (audio-only) semantic draw over the gathered head
    logits (B, W). Returns vocab ids (B,) int32. samp: per-row knobs
    (dynamic engines), which then replace `sampling`."""
    if is_legacy(lm):
        if noise is None:
            raise ValueError("sample_semantic: the PAD/EOS draw of Fish <= 1.4 needs "
                             "uniforms at every temperature")
        return legacy_pad_eos_sample(
            logits[:, 0], logits[:, 1], token_cfg.pad_id, token_cfg.im_end_id,
            uniform=noise,
        )
    if samp is not None:
        tok = sample_top_k_top_p_dynamic(
            logits, noise, temp=samp.temp, top_p=samp.top_p, top_k=samp.top_k,
            k_max=min(dyn_top_k_cap, logits.shape[-1]))
    else:
        tok = sample_top_k_top_p(
            logits, temp=sampling.temp, top_p=sampling.top_p, top_k=sampling.top_k,
            gumbel=noise,
        )
    return torch.where(
        tok == 0,
        torch.full_like(tok, token_cfg.im_end_id),
        token_cfg.semantic_start_id + tok - 1,
    ).to(torch.int32)


class FrameResult(NamedTuple):
    tokens: torch.Tensor  # (B, C+1) int32: semantic + codebook rows
    is_eos: torch.Tensor  # (B,) bool
    rep_pen: RepPenWindow


def generate_frame(params, cfg: DualARConfig, token_cfg: TokenConfig, lm: WhichLM,
                   sampling: SamplingArgs, logits: torch.Tensor, hidden: torch.Tensor,
                   rep_pen: RepPenWindow, prev_tokens: Optional[torch.Tensor],
                   noise: Optional[FrameNoise], rope,
                   use_fused_fast: bool = False, samp: Optional[RowSampling] = None,
                   dyn_top_k_cap: int = 256,
                   sync_state: Optional[torch.Tensor] = None, tp=None) -> FrameResult:
    """Sample the semantic token, then run the fast transformer over the
    codebook axis. prev_tokens: the previous frame (B, C+1), or None on
    the prefill frame; noise: None only in static argmax mode (Fish 1.5 /
    DualAR).

    samp: per-row knobs of a dynamic engine; `sampling` is then ignored,
    the rep-pen window is pushed every frame (rows at penalty 1.0 divide
    by 1.0) unless depthwise_wte, and noise has the dynamic layout.
    use_fused_fast: the whole codebook loop is one call fed the same
    draws, `ops.fast_frame` (static, batch 1) or `ops.fast_frame_batched`
    (dynamic). sync_state: the fused frames' grid sync state (the
    engine's own). tp: the parameters are this rank's tensor-parallel
    shard (`models/dual_ar.py`); the unfused codebook loop only."""
    dynamic = samp is not None
    if noise is None and (dynamic or not sampling.is_argmax or is_legacy(lm)):
        raise ValueError("generate_frame: this frame needs noise")
    semantic = sample_semantic(
        logits, lm, token_cfg, sampling, None if noise is None else noise.semantic,
        samp, dyn_top_k_cap)
    is_eos = semantic == token_cfg.im_end_id

    # push the previous frame's codebook tokens, then penalise
    rep_pen_enabled = not cfg.depthwise_wte and (
        dynamic or sampling.repetition_penalty != 1.0)
    if prev_tokens is not None and rep_pen_enabled:
        rep_pen = rep_pen.push(prev_tokens[:, 1:])

    if use_fused_fast and dynamic:
        toks = fused_fast_frame_batched(params, cfg, samp, hidden, rep_pen.tokens,
                                        noise.codebooks, is_eos, rope,
                                        rep_enabled=rep_pen_enabled, sync=sync_state)
        frame = torch.cat([semantic[:, None], toks], dim=1)
        return FrameResult(tokens=frame, is_eos=is_eos, rep_pen=rep_pen)
    if use_fused_fast:
        gumbel = None if sampling.is_argmax else torch.cat(noise.codebooks)  # (C, k_eff)
        toks = fused_fast_frame(params, cfg, sampling, hidden, rep_pen.tokens[0], gumbel,
                                is_eos, rope, rep_enabled=rep_pen_enabled, sync=sync_state)
        frame = torch.cat([semantic[:, None], toks[None, :]], dim=1)
        return FrameResult(tokens=frame, is_eos=is_eos, rep_pen=rep_pen)

    b = logits.shape[0]
    hist = fast_hist_init(cfg, b, hidden.dtype, hidden.device, tp)
    x = hidden[:, None, :]
    toks = []
    for cb in range(cfg.num_codebooks):
        cb_logits, hist = fast_step(params, cfg, x, hist, cb, rope, tp=tp)
        if rep_pen_enabled:
            row = RepPenWindow(tokens=rep_pen.tokens[:, cb], ptr=rep_pen.ptr)
            cb_logits = (row.penalize_rows(cb_logits, samp.rep_pen) if dynamic
                         else row.penalize(cb_logits, sampling.repetition_penalty))
        if dynamic:
            tok = sample_top_k_top_p_dynamic(
                cb_logits, noise.codebooks[:, cb], temp=samp.temp, top_p=samp.top_p,
                top_k=samp.top_k, k_max=min(dyn_top_k_cap, cfg.codebook_size))
        else:
            tok = sample_top_k_top_p(
                cb_logits, temp=sampling.temp, top_p=sampling.top_p, top_k=sampling.top_k,
                gumbel=None if sampling.is_argmax else noise.codebooks[cb],
            )
        tok = torch.where(is_eos, torch.zeros_like(tok), tok)  # EOS frames emit 0s
        if cb + 1 < cfg.num_codebooks:  # the last token feeds no further step
            x = fast_embed(params, cfg, tok, cb, tp)
        toks.append(tok)
    frame = torch.cat([semantic[:, None], torch.stack(toks, dim=1)], dim=1)
    return FrameResult(tokens=frame, is_eos=is_eos, rep_pen=rep_pen)
