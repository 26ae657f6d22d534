"""Teacher-forced DualAR training loss: the port of
`fish_speech_tpu/train/loss.py`. The forwards also serve the quality
proxies (`utils/quality.py`).

* slow stack: a full-sequence causal forward over the frame axis; the
  hidden at position t predicts the semantic token of frame t+1, the
  next-frame convention of the decode loop.
* fast stack: for every position t, a C-step causal forward over the
  codebook axis, teacher-forced with frame t+1's codebooks: inputs
  [hidden_t, femb(cb_0), ..., femb(cb_{C-2})], targets [cb_0, ...,
  cb_{C-1}], RoPE indexed by codebook position.

The losses are masked: the slow cross-entropy over real next positions,
the fast one only where the next frame is an audio frame (its semantic
token in the semantic range, or `<|semantic|>` for Fish <= 1.4): text
frames carry zero codebooks.

Every stack product goes through `ops.quant.matmul`, so an
int8-quantized parameter set runs the same forwards. Plain PyTorch on
whatever device the parameters lie on, differentiated by autograd: the
JAX package trains through plain XLA ops too, and no kernel of the port
is on this path.

Under a (dp, tp) mesh (`mesh=`), the parameters are one rank's tp shard
(`parallel.mesh.shard_lm_params`) and the batch its dp rows
(`train.step.shard_batch`). The layers run on the rank's heads and FFN
columns through the tp collectives of `parallel/mesh.py`, which autograd
differentiates; the heads' logits are gathered whole. Each cross-entropy
divides the rank's masked sum by the count of the whole batch (an
all-reduce over dp), so the sum of the ranks' losses is the JAX loss, a
mean over the global batch's masked positions; the metrics are the
global ones. Remat recomputes a layer's collectives in the backward, in
the same order on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fish_speech_tpu_torch.config import DualARConfig, TokenConfig
from fish_speech_tpu_torch.models.dual_ar import (
    _attn_out_ffn, _layer, _project_qkv, embed_tokens, rope_tables)
from fish_speech_tpu_torch.ops.attention import NEG_INF, gqa_attention
from fish_speech_tpu_torch.ops.norms import rms_norm
from fish_speech_tpu_torch.ops.rope import apply_rope_interleaved
from fish_speech_tpu_torch.parallel.distributed import all_reduce
from fish_speech_tpu_torch.parallel.mesh import TensorParallel


def _layer_train(x, lp, cos, sin, mask, cfg: DualARConfig, tp=None):
    """One transformer layer without a KV cache (on this rank's heads and
    FFN columns under tp)."""
    h = rms_norm(x, lp["attention_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(h, lp, cfg, tp)
    q = apply_rope_interleaved(q, cos, sin)
    k = apply_rope_interleaved(k, cos, sin)
    attn = gqa_attention(q, k, v, mask, 1.0 / (cfg.head_dim**0.5))
    return _attn_out_ffn(x, attn, lp, cfg, tp=tp)


def _bias(allowed: torch.Tensor) -> torch.Tensor:
    return torch.where(allowed, 0.0, NEG_INF).to(torch.float32)


def slow_forward_full(params, cfg: DualARConfig, token_cfg: TokenConfig,
                      tokens: torch.Tensor, seq_lens: torch.Tensor,
                      remat: bool = True, tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Pre-norm hidden states at every position, (B, S, D), for tokens
    (B, C+1, S) with real lengths seq_lens (B,): causal, within the
    max_seq_len window, keys past a row's length masked. remat: while
    grad is enabled, each layer keeps only its input for the backward and
    runs again there (the JAX package's jax.checkpoint of the layer).
    tp: the parameters are this rank's tp shard."""
    _, _, s = tokens.shape
    x = embed_tokens(params, cfg, token_cfg, tokens, tp)
    cos_t, sin_t = rope_tables(cfg, x.device)
    cos, sin = cos_t[:s], sin_t[:s]
    q_pos = torch.arange(s, device=x.device)[:, None]
    k_pos = torch.arange(s, device=x.device)[None, :]
    causal = (k_pos <= q_pos) & (q_pos - k_pos < cfg.max_seq_len)
    k_valid = k_pos < seq_lens.to(x.device)[:, None]  # (B, S)
    mask = _bias(causal[None] & k_valid[:, None, :])[:, None]
    remat = remat and torch.is_grad_enabled()
    for l in range(cfg.n_layer):
        lp = _layer(params["slow"], l)
        if remat:
            x = checkpoint(_layer_train, x, lp, cos, sin, mask, cfg, tp, use_reentrant=False)
        else:
            x = _layer_train(x, lp, cos, sin, mask, cfg, tp)
    return x


def _head(x: torch.Tensor, w: torch.Tensor, width: int,
          tp: Optional[TensorParallel]) -> torch.Tensor:
    """x @ W in float32; under tp W is column-split (padded) and its
    `width` real columns are gathered, so padding stays out of the
    softmax."""
    return (x @ w).float() if tp is None else tp.columns(x, w, 0, width)


def fast_forward_teacher(params, cfg: DualARConfig, hidden: torch.Tensor,
                         codebooks: torch.Tensor,
                         tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Teacher-forced fast-stack logits (N, C, codebook_size) float32 for
    slow hidden rows (N, D) and their frames' codebooks (N, C)."""
    n, c = codebooks.shape
    cb_in = codebooks[:, :c - 1].long()
    if cfg.depthwise_wte:
        cb_in = cb_in + torch.arange(c - 1, device=cb_in.device)[None, :] * cfg.codebook_size
    if tp is None:
        emb = F.embedding(cb_in, params["fast_embeddings"])  # (N, C-1, D); see embed_tokens
    else:
        emb = tp.lookup(params["fast_embeddings"], cb_in)
    x = torch.cat([hidden[:, None, :].to(emb.dtype), emb], dim=1)
    cos_t, sin_t = rope_tables(cfg, x.device)
    pos = torch.arange(c, device=x.device)
    mask = _bias(pos[None, :] <= pos[:, None])[None, None]
    for l in range(cfg.n_fast_layer):
        x = _layer_train(x, _layer(params["fast"], l), cos_t[:c], sin_t[:c], mask, cfg, tp)
    fast_out = rms_norm(x, params["fast_norm"], cfg.norm_eps)
    logits = _head(fast_out, params["fast_output"], cfg.fast_output_size, tp)  # (N, C, W)
    if cfg.depthwise_output:
        # step i scores against its own column block of the head
        logits = logits.reshape(n, c, cfg.num_codebooks, cfg.codebook_size)[:, pos, pos]
    return logits


def _masked_ce(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor, dp=None):
    """Mean cross-entropy over the mask's True positions: (loss, count,
    argmax accuracy). dp: the group this rank's rows share a batch with;
    the count is the whole batch's, so the loss and accuracy are this
    rank's parts of the global means (their sums over dp)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    count = torch.sum(mask)
    if dp is not None:
        count = all_reduce(count.clone(), dp)
    n = torch.clamp(count, min=1)
    loss = torch.sum(torch.where(mask, nll, 0.0)) / n
    acc = torch.sum(mask & (torch.argmax(logits, dim=-1) == targets)) / n
    return loss, count, acc


def dual_ar_loss(params, cfg: DualARConfig, token_cfg: TokenConfig,
                 batch: Dict[str, torch.Tensor], fast_weight: float = 1.0,
                 remat: bool = True, mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: {"tokens": (B, C+1, S) int, "seq_lens": (B,) int}. Returns
    (total loss, metrics), all tensors on the parameters' device: the slow
    cross-entropy of each next position's semantic token plus fast_weight
    times the fast cross-entropy of each next audio frame's codebooks.
    mesh: a (dp, tp) mesh, the parameters this rank's tp shard and the
    batch its dp rows; the loss returned is then this rank's part (the
    ranks' losses over dp sum to the global one) and the metrics are
    global."""
    tokens = batch["tokens"]
    seq_lens = batch["seq_lens"]
    b, cp1, s = tokens.shape
    c = cp1 - 1
    tp = TensorParallel.of(mesh)
    dp = mesh.get_group("dp") if mesh is not None and mesh.size(0) > 1 else None
    hidden = slow_forward_full(params, cfg, token_cfg, tokens, seq_lens, remat=remat, tp=tp)

    # slow head: position t predicts the semantic token at t+1
    slow_out = rms_norm(hidden, params["norm"], cfg.norm_eps)
    slow_logits = _head(slow_out[:, :-1, :], params["output"], cfg.vocab_size, tp)
    sem_targets = tokens[:, 0, 1:]  # (B, S-1)
    valid_next = (torch.arange(1, s, device=tokens.device)[None, :]
                  < seq_lens.to(tokens.device)[:, None])
    slow_loss, slow_n, slow_acc = _masked_ce(slow_logits, sem_targets, valid_next, dp)

    # fast head: hidden_t predicts frame t+1's codebooks, audio frames only
    if token_cfg.semantic_end_id is not None:
        is_audio = ((sem_targets >= token_cfg.semantic_start_id)
                    & (sem_targets <= token_cfg.semantic_end_id))
    else:
        is_audio = sem_targets == token_cfg.semantic_start_id
    fast_mask = is_audio & valid_next  # (B, S-1)
    cb_targets = tokens[:, 1:, 1:].transpose(1, 2)  # (B, S-1, C)
    n = b * (s - 1)
    fast_logits = fast_forward_teacher(
        params, cfg, hidden[:, :-1, :].reshape(n, cfg.dim), cb_targets.reshape(n, c), tp,
    ).reshape(b, s - 1, c, -1)
    fast_loss, fast_n, fast_acc = _masked_ce(
        fast_logits, cb_targets, fast_mask[..., None].expand(b, s - 1, c), dp)

    total = slow_loss + fast_weight * fast_loss
    parts = {"loss": total, "slow_loss": slow_loss, "fast_loss": fast_loss,
             "slow_acc": slow_acc, "fast_acc": fast_acc}
    if dp is not None:
        # the global metrics: the sums over dp of the ranks' parts
        summed = all_reduce(torch.stack([v.detach().float() for v in parts.values()]), dp)
        parts = dict(zip(parts, summed.unbind()))
    return total, dict(parts, slow_tokens=slow_n, fast_tokens=fast_n)
