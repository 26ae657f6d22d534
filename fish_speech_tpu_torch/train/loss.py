"""Teacher-forced DualAR forwards: the forward half of
`fish_speech_tpu/train/loss.py` (l.52-154), used by the quality proxies
(`utils/quality.py`). The losses and every backward wait for the
training port.

* slow stack: a full-sequence causal forward over the frame axis; the
  hidden at position t predicts the semantic token of frame t+1, the
  next-frame convention of the decode loop.
* fast stack: for every position t, a C-step causal forward over the
  codebook axis, teacher-forced with frame t+1's codebooks: inputs
  [hidden_t, femb(cb_0), ..., femb(cb_{C-2})], targets [cb_0, ...,
  cb_{C-1}], RoPE indexed by codebook position.

Every stack product goes through `ops.quant.matmul`, so an
int8-quantized parameter set runs the same forwards. Plain PyTorch on
whatever device the parameters lie on; no kernel of the port is used.
"""

from __future__ import annotations

import torch

from fish_speech_tpu_torch.config import DualARConfig, TokenConfig
from fish_speech_tpu_torch.models.dual_ar import (
    _attn_out_ffn, _layer, _project_qkv, embed_tokens, rope_tables)
from fish_speech_tpu_torch.ops.attention import NEG_INF, gqa_attention
from fish_speech_tpu_torch.ops.norms import rms_norm
from fish_speech_tpu_torch.ops.rope import apply_rope_interleaved


def _layer_train(x, lp, cos, sin, mask, cfg: DualARConfig):
    """One transformer layer without a KV cache."""
    h = rms_norm(x, lp["attention_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(h, lp, cfg)
    q = apply_rope_interleaved(q, cos, sin)
    k = apply_rope_interleaved(k, cos, sin)
    attn = gqa_attention(q, k, v, mask, 1.0 / (cfg.head_dim**0.5))
    return _attn_out_ffn(x, attn, lp, cfg)


def _bias(allowed: torch.Tensor) -> torch.Tensor:
    return torch.where(allowed, 0.0, NEG_INF).to(torch.float32)


def slow_forward_full(params, cfg: DualARConfig, token_cfg: TokenConfig,
                      tokens: torch.Tensor, seq_lens: torch.Tensor) -> torch.Tensor:
    """Pre-norm hidden states at every position, (B, S, D), for tokens
    (B, C+1, S) with real lengths seq_lens (B,): causal, within the
    max_seq_len window, keys past a row's length masked."""
    _, _, s = tokens.shape
    x = embed_tokens(params, cfg, token_cfg, tokens)
    cos_t, sin_t = rope_tables(cfg, x.device)
    cos, sin = cos_t[:s], sin_t[:s]
    q_pos = torch.arange(s, device=x.device)[:, None]
    k_pos = torch.arange(s, device=x.device)[None, :]
    causal = (k_pos <= q_pos) & (q_pos - k_pos < cfg.max_seq_len)
    k_valid = k_pos < seq_lens.to(x.device)[:, None]  # (B, S)
    mask = _bias(causal[None] & k_valid[:, None, :])[:, None]
    for l in range(cfg.n_layer):
        x = _layer_train(x, _layer(params["slow"], l), cos, sin, mask, cfg)
    return x


def fast_forward_teacher(params, cfg: DualARConfig, hidden: torch.Tensor,
                         codebooks: torch.Tensor) -> torch.Tensor:
    """Teacher-forced fast-stack logits (N, C, codebook_size) float32 for
    slow hidden rows (N, D) and their frames' codebooks (N, C)."""
    n, c = codebooks.shape
    cb_in = codebooks[:, :c - 1].long()
    if cfg.depthwise_wte:
        cb_in = cb_in + torch.arange(c - 1, device=cb_in.device)[None, :] * cfg.codebook_size
    emb = params["fast_embeddings"][cb_in]  # (N, C-1, D)
    x = torch.cat([hidden[:, None, :].to(emb.dtype), emb], dim=1)
    cos_t, sin_t = rope_tables(cfg, x.device)
    pos = torch.arange(c, device=x.device)
    mask = _bias(pos[None, :] <= pos[:, None])[None, None]
    for l in range(cfg.n_fast_layer):
        x = _layer_train(x, _layer(params["fast"], l), cos_t[:c], sin_t[:c], mask, cfg)
    fast_out = rms_norm(x, params["fast_norm"], cfg.norm_eps)
    logits = (fast_out @ params["fast_output"]).float()  # (N, C, W)
    if cfg.depthwise_output:
        # step i scores against its own column block of the head
        logits = logits.reshape(n, c, cfg.num_codebooks, cfg.codebook_size)[:, pos, pos]
    return logits
