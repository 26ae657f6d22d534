"""Sampling: temperature / top-k / top-p with injected Gumbel noise, the
two-way PAD-vs-EOS draw of Fish <= 1.4, and the sliding-window
repetition penalty; each with static knobs (`SamplingArgs`) and with
per-row knobs as tensors (`RowSampling`, the dynamic engines').

The JAX package draws its noise from `jax.random` inside the sampler.
Here the noise is an argument, or drawn from an explicit
`torch.Generator` when none is given, so tests can feed both packages
the same draws and compare token streams exactly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingArgs:
    temp: float = 0.7
    top_p: float = 0.8
    top_k: int = 256
    repetition_penalty: float = 1.2

    @property
    def is_argmax(self) -> bool:
        return self.temp <= 1e-7


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(U)), U uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def top_k_width(top_k: int, vocab: int) -> int:
    """Width of the top-k window, and of the Gumbel noise it takes."""
    return min(top_k, vocab)


def top_k_sorted(probs: torch.Tensor, k: int):
    """The k largest entries of the last axis and their indices, in the
    order of `jax.lax.top_k`: value descending, ties by lower index
    (`torch.topk` leaves the order of ties open)."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def sample_top_k_top_p(
    logits: torch.Tensor,
    *,
    temp: float,
    top_p: float,
    top_k: int,
    gumbel: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sample ids from logits (..., V) -> (...) int32. temp <= 1e-7 is
    argmax. gumbel: (..., min(top_k, V)) float32 noise; drawn from
    `generator` when None."""
    if temp <= 1e-7:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temp
    k = top_k_width(top_k, logits.shape[-1])
    probs = torch.softmax(logits, dim=-1)
    top_probs, top_idx = top_k_sorted(probs, k)
    if 0.0 < top_p < 1.0:
        cum_excl = torch.cumsum(top_probs, dim=-1) - top_probs
        top_probs = torch.where(cum_excl < top_p, top_probs, torch.zeros_like(top_probs))
    if gumbel is None:
        gumbel = gumbel_noise(top_probs.shape, generator, logits.device)
    scores = torch.where(
        top_probs > 0.0,
        torch.log(top_probs) + gumbel,
        torch.full_like(top_probs, float("-inf")),
    )
    choice = torch.argmax(scores, dim=-1, keepdim=True)
    return torch.gather(top_idx, -1, choice).squeeze(-1).to(torch.int32)


class RowSampling(NamedTuple):
    """Per-row sampling parameters as tensors, the dynamic counterpart
    of `SamplingArgs`: one decode program serves rows with different
    configs. temp/top_p/rep_pen (B,) float32; top_k (B,) int32, <= 0
    meaning "all"."""

    temp: torch.Tensor
    top_p: torch.Tensor
    top_k: torch.Tensor
    rep_pen: torch.Tensor

    @staticmethod
    def broadcast(args: SamplingArgs, batch: int, device=None) -> "RowSampling":
        return RowSampling.from_vectors(
            torch.from_numpy(np.tile(RowSampling.row_vector(args), (batch, 1))).to(device))

    @staticmethod
    def row_vector(args: SamplingArgs) -> np.ndarray:
        """(4,) float32 [temp, top_p, top_k, rep_pen]: one row's operand."""
        return np.array([args.temp, args.top_p, float(args.top_k),
                         args.repetition_penalty], np.float32)

    @staticmethod
    def from_vectors(vecs: torch.Tensor) -> "RowSampling":
        """(k, 4) float32 row vectors -> RowSampling of k rows."""
        return RowSampling(temp=vecs[:, 0].contiguous(), top_p=vecs[:, 1].contiguous(),
                           top_k=vecs[:, 2].to(torch.int32), rep_pen=vecs[:, 3].contiguous())

    def set_rows(self, row0: int, vecs: torch.Tensor) -> "RowSampling":
        """A copy with (k, 4) row vectors spliced into rows [row0, row0+k)."""
        new = RowSampling.from_vectors(vecs.to(self.temp.device))
        out = []
        for old, rows in zip(self, new):
            t = old.clone()
            t[row0:row0 + rows.shape[0]] = rows
            out.append(t)
        return RowSampling(*out)


def sample_top_k_top_p_dynamic(
    logits: torch.Tensor,
    gumbel: torch.Tensor,
    *,
    temp: torch.Tensor,
    top_p: torch.Tensor,
    top_k: torch.Tensor,
    k_max: int,
) -> torch.Tensor:
    """Per-row sampling: logits (B, V), gumbel (B, min(k_max, V))
    float32, temp/top_p (B,) float32, top_k (B,) int32 -> (B,) int32.
    The semantics of `sample_top_k_top_p` with every knob per row: rows
    with temp <= 1e-7 take the top token of softmax(logits / 1e-6);
    top_k <= 0 or > k means k = min(k_max, V); top_p outside (0, 1)
    keeps the whole mass."""
    logits = logits.float()
    k = min(k_max, logits.shape[-1])
    t = torch.clamp(temp, min=1e-6)[:, None]
    probs = torch.softmax(logits / t, dim=-1)
    top_probs, top_idx = top_k_sorted(probs, k)
    k_eff = torch.where((top_k <= 0) | (top_k > k), torch.full_like(top_k, k), top_k)
    ranks = torch.arange(k, device=logits.device)[None, :]
    top_probs = torch.where(ranks < k_eff[:, None], top_probs, torch.zeros_like(top_probs))
    p_eff = torch.where((top_p <= 0.0) | (top_p >= 1.0), torch.ones_like(top_p), top_p)
    cum_excl = torch.cumsum(top_probs, dim=-1) - top_probs
    top_probs = torch.where(cum_excl < p_eff[:, None], top_probs, torch.zeros_like(top_probs))
    scores = torch.where(
        top_probs > 0.0,
        torch.log(top_probs) + gumbel,
        torch.full_like(top_probs, float("-inf")),
    )
    choice = torch.argmax(scores, dim=-1, keepdim=True)
    sampled = torch.gather(top_idx, -1, choice).squeeze(-1)
    return torch.where(temp <= 1e-7, top_idx[:, 0], sampled).to(torch.int32)


def legacy_pad_eos_sample(
    pad_logit: torch.Tensor,
    eos_logit: torch.Tensor,
    pad_id: int,
    eos_id: int,
    *,
    uniform: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Two-way PAD vs <|im_end|> softmax draw for Fish <= 1.4 slow heads.
    uniform: U(0, 1) draws shaped like the logits; drawn from `generator`
    when None. Fed (B,) uniforms from each row's own stream, it is also
    the JAX package's `legacy_pad_eos_sample_rows`."""
    m = torch.maximum(pad_logit, eos_logit)
    exp_pad = torch.exp(pad_logit - m)
    exp_eos = torch.exp(eos_logit - m)
    p_pad = exp_pad / (exp_pad + exp_eos)
    if uniform is None:
        uniform = torch.rand(
            p_pad.shape, generator=generator, device=p_pad.device, dtype=torch.float32
        )
    pad = torch.full_like(p_pad, pad_id, dtype=torch.int32)
    eos = torch.full_like(p_pad, eos_id, dtype=torch.int32)
    return torch.where(uniform < p_pad, pad, eos)


class RepPenWindow(NamedTuple):
    """Ring buffer of recently sampled tokens, one row per
    (batch, codebook): tokens (..., window) int32, -1 matches nothing;
    ptr is the next write slot, shared by all rows (a host int)."""

    tokens: torch.Tensor
    ptr: int

    @staticmethod
    def init(shape_prefix: tuple, window: int, device=None) -> "RepPenWindow":
        return RepPenWindow(
            tokens=torch.full(shape_prefix + (window,), -1, dtype=torch.int32, device=device),
            ptr=0,
        )

    def push(self, new_tokens: torch.Tensor) -> "RepPenWindow":
        """Insert one token per row at the current slot."""
        tokens = self.tokens.clone()
        tokens[..., self.ptr] = new_tokens.to(torch.int32)
        return RepPenWindow(tokens=tokens, ptr=(self.ptr + 1) % tokens.shape[-1])

    def penalize(self, logits: torch.Tensor, penalty: float) -> torch.Tensor:
        """Divide the logits of tokens present in the window by
        `penalty` (plain division whatever the sign)."""
        if penalty == 1.0:
            return logits
        return self._divide(logits, torch.full((), penalty, dtype=torch.float32,
                                               device=logits.device))

    def penalize_rows(self, logits: torch.Tensor, penalty: torch.Tensor) -> torch.Tensor:
        """`penalize` with a per-row penalty: logits (B, V), penalty (B,)
        float32; rows at 1.0 are divided by 1.0, which changes nothing."""
        return self._divide(logits, penalty.float()[:, None])

    def _divide(self, logits: torch.Tensor, penalty: torch.Tensor) -> torch.Tensor:
        """logits / penalty where the token is in the window."""
        vocab_ids = torch.arange(logits.shape[-1], dtype=torch.int32, device=logits.device)
        member = torch.any(self.tokens[..., :, None] == vocab_ids, dim=-2)
        divisor = torch.where(member, penalty,
                              torch.ones((), dtype=torch.float32, device=logits.device))
        return (logits.float() / divisor).to(logits.dtype)

SINGLE_STREAM_REP_PEN_WINDOW = 16  # the rep-pen window of batch-1 generation
BATCHED_REP_PEN_WINDOW = 12  # the rep-pen window of batched serving
