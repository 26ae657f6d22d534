"""One DualAR frame: constrained semantic sampling, then the fast
codebook loop. Counterpart of `fish_speech_tpu/generate/frame.py`
(the unfused, static-sampling path).

Noise is explicit: a `FrameNoise` carries the Gumbel draws of the
semantic head and of each codebook step. Tests build it from the JAX
package's own `jax.random` draws; the engine draws it from a
`torch.Generator`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from fish_speech_tpu_torch.config import DualARConfig, TokenConfig, WhichLM
from fish_speech_tpu_torch.models.dual_ar import fast_embed, fast_hist_init, fast_step
from fish_speech_tpu_torch.ops.fast_frame import fused_fast_frame
from fish_speech_tpu_torch.ops.sampling import (
    RepPenWindow,
    SamplingArgs,
    gumbel_noise,
    legacy_pad_eos_sample,
    sample_top_k_top_p,
    top_k_width,
)


def semantic_head_columns(lm: WhichLM, token_cfg: TokenConfig,
                          cfg: DualARConfig) -> np.ndarray:
    """LM-head columns that constrained semantic sampling can read. The
    engine gathers the output weight down to these once, so the
    per-frame head product reads ~1 MB instead of ~200 MB.
    Fish <= 1.4: [pad, im_end]; 1.5 / DualAR: [im_end] ++ semantic range."""
    if lm in (WhichLM.FISH_1_2, WhichLM.FISH_1_4):
        return np.array([token_cfg.pad_id, token_cfg.im_end_id], np.int32)
    return np.concatenate([
        np.array([token_cfg.im_end_id], np.int32),
        token_cfg.semantic_start_id + np.arange(cfg.codebook_size, dtype=np.int32),
    ])


class FrameNoise(NamedTuple):
    """Random draws of one frame. semantic: (B, k) Gumbel noise for the
    semantic head (Fish 1.5) or (B,) uniforms for the PAD/EOS draw
    (Fish <= 1.4); codebooks: one (B, k_cb) Gumbel tensor per codebook."""

    semantic: torch.Tensor
    codebooks: List[torch.Tensor]


def draw_frame_noise(lm: WhichLM, cfg: DualARConfig, sampling: SamplingArgs,
                     batch: int, head_width: int, generator: torch.Generator,
                     device) -> Optional[FrameNoise]:
    """One frame's draws from `generator`; None in argmax mode."""
    if sampling.is_argmax:
        return None
    if lm in (WhichLM.FISH_1_2, WhichLM.FISH_1_4):
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


def sample_semantic(logits: torch.Tensor, lm: WhichLM, token_cfg: TokenConfig,
                    sampling: SamplingArgs, noise: Optional[torch.Tensor]) -> torch.Tensor:
    """Constrained (audio-only) semantic draw over the gathered head
    logits (B, W). Returns vocab ids (B,) int32."""
    if lm in (WhichLM.FISH_1_2, WhichLM.FISH_1_4):
        return legacy_pad_eos_sample(
            logits[:, 0], logits[:, 1], token_cfg.pad_id, token_cfg.im_end_id,
            uniform=noise,
        )
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
                   use_fused_fast: bool = False) -> FrameResult:
    """Sample the semantic token, then run the fast transformer over the
    codebook axis. prev_tokens: the previous frame (B, C+1), or None on
    the prefill frame; noise: None only in argmax mode. use_fused_fast
    (batch 1): the whole codebook loop is one `ops.fast_frame` call fed
    the same per-codebook draws."""
    if noise is None and not sampling.is_argmax:
        raise ValueError("generate_frame: sampling needs noise")
    semantic = sample_semantic(
        logits, lm, token_cfg, sampling, None if noise is None else noise.semantic)
    is_eos = semantic == token_cfg.im_end_id

    # push the previous frame's codebook tokens, then penalise
    rep_pen_enabled = not cfg.depthwise_wte and sampling.repetition_penalty != 1.0
    if prev_tokens is not None and rep_pen_enabled:
        rep_pen = rep_pen.push(prev_tokens[:, 1:])

    if use_fused_fast:
        gumbel = None if noise is None else torch.cat(noise.codebooks)  # (C, k_eff)
        toks = fused_fast_frame(params, cfg, sampling, hidden, rep_pen.tokens[0], gumbel,
                                is_eos, rope, rep_enabled=rep_pen_enabled)
        frame = torch.cat([semantic[:, None], toks[None, :]], dim=1)
        return FrameResult(tokens=frame, is_eos=is_eos, rep_pen=rep_pen)

    b = logits.shape[0]
    hist = fast_hist_init(cfg, b, hidden.dtype, hidden.device)
    x = hidden[:, None, :]
    toks = []
    for cb in range(cfg.num_codebooks):
        cb_logits, hist = fast_step(params, cfg, x, hist, cb, rope)
        if rep_pen_enabled:
            row = RepPenWindow(tokens=rep_pen.tokens[:, cb], ptr=rep_pen.ptr)
            cb_logits = row.penalize(cb_logits, sampling.repetition_penalty)
        tok = sample_top_k_top_p(
            cb_logits, temp=sampling.temp, top_p=sampling.top_p, top_k=sampling.top_k,
            gumbel=None if noise is None else noise.codebooks[cb],
        )
        tok = torch.where(is_eos, torch.zeros_like(tok), tok)  # EOS frames emit 0s
        if cb + 1 < cfg.num_codebooks:  # the last token feeds no further step
            x = fast_embed(params, cfg, tok, cb)
        toks.append(tok)
    frame = torch.cat([semantic[:, None], torch.stack(toks, dim=1)], dim=1)
    return FrameResult(tokens=frame, is_eos=is_eos, rep_pen=rep_pen)
