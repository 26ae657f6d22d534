"""DualAR transformer in PyTorch.

Counterpart of `fish_speech_tpu/models/dual_ar.py`, with the same
parameter layout, so one converter serves both packages:

  {"embeddings": (V, D), "codebook_embeddings": (C*CB, D),
   "fast_embeddings": (fast_vocab, D), "norm": (D,), "fast_norm": (D,),
   "output": (D, V), "fast_output": (D, fast_out),
   "slow": {stacked (L, ...): wqkv (L, D, (H+2KV)*hd), wo, w1, w3, w2,
            attention_norm, ffn_norm},
   "fast": {the same, stacked over the fast layers}}

Linear weights are (in, out) and applied as `x @ w`. A stack's matmul
weights may be int8-quantized (`ops/quant.py`: {"q": (L, in, out) int8,
"s": (L, 1, out) bf16}); every stack product goes through
`ops.quant.matmul`.

* The KV cache is a static `(L, B, KV, S, hd)` buffer updated in place.
* Prefill attention goes through `ops.prefill_attention` and decode
  attention through `ops.decode_attention`: on CUDA tensors they launch
  the port's kernels, on CPU tensors they run the plain versions.
* Rows track their own positions; rewinding to a conditioning prefix is
  a change of the position counter only.
* `tp`: a `parallel.mesh.TensorParallel` when the parameters are one
  rank's tensor-parallel shard (`parallel.mesh.shard_lm_params`): the
  layers then run on the rank's own heads and FFN columns, with an
  all-reduce after wo and after w2, vocab-split lookups (a masked local
  gather, then an all-reduce) and column-split heads whose logits are
  gathered. Attention needs no communication. The collectives are
  autograd functions (`parallel/mesh.py`): the replicated input of every
  column-split product goes through `tp.copy`, whose backward sums the
  gradient over the ranks, so training differentiates the sharded layers.
  None: unsharded.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from fish_speech_tpu_torch.config import DualARConfig, TokenConfig
from fish_speech_tpu_torch.ops.decode_attention import decode_attention, decode_attention_sharded
from fish_speech_tpu_torch.ops.norms import rms_norm
from fish_speech_tpu_torch.ops.prefill_attention import prefill_attention
from fish_speech_tpu_torch.ops.attention import gqa_attention
from fish_speech_tpu_torch.ops.quant import is_quantized
from fish_speech_tpu_torch.ops.quant import matmul as _mm
from fish_speech_tpu_torch.ops.rope import apply_rope_interleaved, precompute_freqs_cis

DualARParams = Dict[str, object]


class KVCache(NamedTuple):
    """Static KV cache for one transformer stack: (L, B, KV, S, hd)."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @staticmethod
    def init(n_layer, batch, n_kv_heads, max_len, head_dim,
             dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (n_layer, batch, n_kv_heads, max_len, head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )


def _stack_init(gen, n_layer, cfg: DualARConfig, dtype, device):
    d, f = cfg.dim, cfg.ffn_dim
    qkv_out = (cfg.n_head + 2 * cfg.n_local_heads) * cfg.head_dim

    def w(*shape):
        return _normal(gen, shape, cfg.initializer_range, dtype, device)

    return {
        "wqkv": w(n_layer, d, qkv_out),
        "wo": w(n_layer, d, d),
        "w1": w(n_layer, d, f),
        "w3": w(n_layer, d, f),
        "w2": w(n_layer, f, d),
        "attention_norm": torch.ones((n_layer, d), dtype=dtype, device=device),
        "ffn_norm": torch.ones((n_layer, d), dtype=dtype, device=device),
    }


def _normal(gen, shape, scale, dtype, device):
    out = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (out * scale).to(dtype)


def init_dual_ar_params(cfg: DualARConfig, seed: int = 0,
                        dtype=torch.bfloat16, device="cuda") -> DualARParams:
    """Random-init parameters from a seed, made on `device` (for tests
    and benchmarks without weights). The draws differ from the JAX
    initialiser's; tests carry JAX parameters across with io.convert."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    emb = _normal(gen, (cfg.vocab_size, cfg.dim), cfg.initializer_range, dtype, device)
    return {
        "embeddings": emb,
        "codebook_embeddings": _normal(
            gen, (cfg.codebook_size * cfg.num_codebooks, cfg.dim),
            cfg.initializer_range, dtype, device),
        "fast_embeddings": _normal(
            gen, (cfg.fast_vocab_size, cfg.dim), cfg.initializer_range, dtype, device),
        "norm": torch.ones((cfg.dim,), dtype=dtype, device=device),
        "fast_norm": torch.ones((cfg.dim,), dtype=dtype, device=device),
        "output": emb.T.contiguous() if cfg.tie_word_embeddings else _normal(
            gen, (cfg.dim, cfg.vocab_size), cfg.initializer_range, dtype, device),
        "fast_output": _normal(
            gen, (cfg.dim, cfg.fast_output_size), cfg.initializer_range, dtype, device),
        "slow": _stack_init(gen, cfg.n_layer, cfg, dtype, device),
        "fast": _stack_init(gen, cfg.n_fast_layer, cfg, dtype, device),
    }


def _layer(stack: Dict[str, object], l: int) -> Dict[str, object]:
    """Layer l of a stacked parameter dict; quantized entries give
    {"q": (in, out), "s": (1, out)} pairs."""
    return {k: ({"q": v["q"][l], "s": v["s"][l]} if is_quantized(v) else v[l])
            for k, v in stack.items()}


# --------------------------------------------------------------------------
# Embedding
# --------------------------------------------------------------------------


def embed_tokens(params, cfg: DualARConfig, token_cfg: TokenConfig,
                 tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """Sum of semantic-token and (masked) codebook embeddings.

    tokens: (B, C+1, S) int -> (B, S, D). Codebook embeddings count only
    where the semantic token is in the semantic range (1.5+) or equals
    PAD (<= 1.4). The rows are gathered by F.embedding, whose backward
    sums a table row's gradients in a fixed order (that of indexing sums
    them in an order that varies from run to run on the CPU). Under tp
    both lookups go through one all-reduce, each exact, before the sum."""
    tokens = tokens.long()
    semantic = tokens[:, 0, :]
    codebooks = tokens[:, 1:, :]
    offsets = (torch.arange(cfg.num_codebooks, device=tokens.device)
               * cfg.codebook_size)[None, :, None]
    if tp is None:
        sem_emb = F.embedding(semantic, params["embeddings"])  # (B, S, D)
        cb_emb = F.embedding(codebooks + offsets, params["codebook_embeddings"])  # (B, C, S, D)
    else:
        both = tp.all_reduce(torch.cat([
            tp.local_lookup(params["embeddings"], semantic)[:, None],
            tp.local_lookup(params["codebook_embeddings"], codebooks + offsets)], dim=1))
        sem_emb, cb_emb = both[:, 0], both[:, 1:]
    if token_cfg.semantic_end_id is not None:
        keep = (semantic >= token_cfg.semantic_start_id) & (
            semantic <= token_cfg.semantic_end_id)
    else:
        keep = semantic == token_cfg.semantic_start_id
    cb_sum = torch.sum(cb_emb, dim=1)
    return sem_emb + torch.where(keep[..., None], cb_sum, torch.zeros_like(cb_sum)).to(sem_emb.dtype)


# --------------------------------------------------------------------------
# Shared block pieces
# --------------------------------------------------------------------------


def local_heads(cfg: DualARConfig, tp=None) -> Tuple[int, int]:
    """(q heads, KV heads) of one rank: all of them without tp."""
    t = 1 if tp is None else tp.size
    return cfg.n_head // t, cfg.n_local_heads // t


def _sum(x, tp):
    """The sum over the tp group of a row-split product's partials."""
    return x if tp is None else tp.all_reduce(x)


def _copy(x, tp):
    """The replicated input of a column-split product (`tp.copy`)."""
    return x if tp is None else tp.copy(x)


def _project_qkv(x, lp, cfg: DualARConfig, tp=None):
    """x (B, S, D) -> q (B, H, S, hd), k, v (B, KV, S, hd), of this rank's
    heads under tp (its wqkv columns are its q, k and v heads)."""
    b, s, _ = x.shape
    h, kv = local_heads(cfg, tp)
    qkv = _mm(_copy(x, tp), lp["wqkv"])
    q_sz = h * cfg.head_dim
    kv_sz = kv * cfg.head_dim
    q = qkv[..., :q_sz].reshape(b, s, h, cfg.head_dim)
    k = qkv[..., q_sz:q_sz + kv_sz].reshape(b, s, kv, cfg.head_dim)
    v = qkv[..., q_sz + kv_sz:].reshape(b, s, kv, cfg.head_dim)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _attn_out_ffn(x, attn, lp, cfg: DualARConfig, unrounded: bool = False, tp=None):
    """Residual attention projection, then the SwiGLU feed-forward.
    unrounded: silu sees the w1 product in float32, as in the fused TPU
    kernels, instead of the product rounded to x's dtype. An int8 w1 has
    no unrounded product: silu sees the rescaled product in x's dtype,
    in the fused TPU kernels too (slow_step_pallas.py:313-323)."""
    b, s, _ = x.shape
    x = x + _sum(_mm(attn.transpose(1, 2).reshape(b, s, -1), lp["wo"]), tp)
    h2 = _copy(rms_norm(x, lp["ffn_norm"], cfg.norm_eps), tp)
    if unrounded and not is_quantized(lp["w1"]):
        up = h2.float() @ lp["w1"].float()
    else:
        up = _mm(h2, lp["w1"]).float()
    gate = F.silu(up).to(x.dtype)
    return x + _sum(_mm(gate * _mm(h2, lp["w3"]), lp["w2"]), tp)


def slow_head(params, cfg: DualARConfig, hidden: torch.Tensor, tp=None,
              width: Optional[int] = None) -> torch.Tensor:
    """The slow head's logits (..., W) float32 of pre-norm hidden states.
    Under tp the head is column-split (padded): its logits are gathered
    and cut to `width`, the head's whole width."""
    out = rms_norm(hidden, params["norm"], cfg.norm_eps)
    if tp is None:
        return (out @ params["output"]).float()
    return tp.columns(out, params["output"], 0, width)


@lru_cache(maxsize=None)
def _rope_host(head_dim: int, max_seq_len: int, rope_base: float):
    return precompute_freqs_cis(head_dim, max_seq_len, rope_base)


def rope_tables(cfg: DualARConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) float32 tables (max_seq_len, hd/2) on `device`."""
    cos, sin = _rope_host(cfg.head_dim, cfg.max_seq_len, cfg.rope_base)
    return (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))


# --------------------------------------------------------------------------
# Slow (semantic) path
# --------------------------------------------------------------------------


def slow_prefill(params, cfg: DualARConfig, token_cfg: TokenConfig,
                 tokens: torch.Tensor, seq_lens: torch.Tensor, cache: KVCache,
                 offset: int, rope, kv_extent: Optional[int] = None, slot: int = 0,
                 tp=None, head_width: Optional[int] = None):
    """Prefill cache rows [slot, slot + B) with a right-padded prompt chunk.

    tokens: (B, C+1, S_pad) int; seq_lens: (B,) int32 real lengths. The
    prompt fills cache positions [offset, offset + S_pad) of those rows
    (positions past the cache end are dropped); other rows are left as
    they are. Attention reads the first `kv_extent` positions (default:
    the whole cache) of the same rows, as row-slice views of the cache;
    the extent must cover offset + max(seq_lens). The cache is updated in
    place. tp / head_width: see `slow_head`.

    Returns (logits (B, V) float32 at each row's last real token,
             hidden (B, D) pre-norm at the same position)."""
    b, _, s_pad = tokens.shape
    x = embed_tokens(params, cfg, token_cfg, tokens, tp)
    cos_t, sin_t = rope
    rope_idx = (offset + torch.arange(s_pad, device=x.device)).clamp(max=cfg.max_seq_len - 1)
    cos, sin = cos_t[rope_idx], sin_t[rope_idx]
    n_write = max(0, min(s_pad, cache.max_len - offset))  # positions inside the cache
    e = kv_extent if kv_extent is not None else cache.max_len

    for l in range(cfg.n_layer):
        lp = _layer(params["slow"], l)
        h = rms_norm(x, lp["attention_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(h, lp, cfg, tp)
        q = apply_rope_interleaved(q, cos, sin)
        k = apply_rope_interleaved(k, cos, sin)
        ck, cv = cache.k[l, slot:slot + b], cache.v[l, slot:slot + b]
        ck[:, :, offset:offset + n_write] = k[:, :, :n_write].to(cache.k.dtype)
        cv[:, :, offset:offset + n_write] = v[:, :, :n_write].to(cache.v.dtype)
        attn = prefill_attention(
            q.contiguous(), ck[:, :, :e], cv[:, :, :e], offset, seq_lens, cfg.max_seq_len,
        )
        x = _attn_out_ffn(x, attn, lp, cfg, tp=tp)

    last_idx = (seq_lens.long() - 1).clamp(0, s_pad - 1)
    hidden = x[torch.arange(b, device=x.device), last_idx]
    return slow_head(params, cfg, hidden, tp, head_width), hidden


def slow_decode_step(params, cfg: DualARConfig, token_cfg: TokenConfig,
                     tokens: torch.Tensor, cache: KVCache, pos: torch.Tensor,
                     rope, tp=None, head_width: Optional[int] = None):
    """One slow-stack decode step for all cache rows.

    tokens: (B, C+1), the previous frame per row; pos: (B,) int32, each
    row's write position. The cache is updated in place; under tp it
    holds this rank's KV heads, and decode attention runs on its heads.
    Returns (logits (B, V) float32, hidden (B, D) pre-norm)."""
    x = embed_tokens(params, cfg, token_cfg, tokens[:, :, None], tp)  # (B, 1, D)
    cos_t, sin_t = rope
    cos = cos_t[pos.long()][:, None, None, :]
    sin = sin_t[pos.long()][:, None, None, :]
    for l in range(cfg.n_layer):
        lp = _layer(params["slow"], l)
        h = rms_norm(x, lp["attention_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(h, lp, cfg, tp)  # (B, heads, 1, hd)
        q = apply_rope_interleaved(q, cos, sin)
        k = apply_rope_interleaved(k, cos, sin)
        args = (q[:, :, 0].contiguous(), k[:, :, 0].to(cache.k.dtype).contiguous(),
                v[:, :, 0].to(cache.v.dtype).contiguous(), pos, cache.k, cache.v, l)
        attn = (decode_attention(*args) if tp is None else decode_attention_sharded(
            *args, heads=(cfg.n_head, cfg.n_local_heads), tp=tp.size))
        x = _attn_out_ffn(x, attn[:, :, None, :], lp, cfg, tp=tp)
    hidden = x[:, 0, :]
    return slow_head(params, cfg, hidden, tp, head_width), hidden


# --------------------------------------------------------------------------
# Fast (codebook) path
# --------------------------------------------------------------------------


def fast_hist_init(cfg: DualARConfig, batch: int, dtype=torch.bfloat16,
                   device=None, tp=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Empty per-layer fast KV history: (k, v) pairs (B, KV, 0, hd), of
    this rank's KV heads under tp."""
    shape = (batch, local_heads(cfg, tp)[1], 0, cfg.head_dim)
    return [
        (torch.zeros(shape, dtype=dtype, device=device),
         torch.zeros(shape, dtype=dtype, device=device))
        for _ in range(cfg.n_fast_layer)
    ]


def fast_step(params, cfg: DualARConfig, x: torch.Tensor, hist, codebook_idx: int,
              rope, unrounded: bool = False, tp=None):
    """One fast-transformer step at codebook position `codebook_idx`.

    x: (B, 1, D); hist: per-layer (k, v) histories (B, KV, codebook_idx,
    hd). The single query attends to the whole history, so no mask.
    unrounded: the w1 product before silu (of a dense stack) and the
    head product stay in float32, as in the fused TPU kernel
    (ops/fast_frame.py). tp: this rank's shard; the head's logits are
    gathered.
    Returns (logits (B, codebook_size) float32, grown hist)."""
    cos_t, sin_t = rope
    cos = cos_t[codebook_idx:codebook_idx + 1]
    sin = sin_t[codebook_idx:codebook_idx + 1]
    scale = 1.0 / cfg.head_dim**0.5
    new_hist = []
    for l in range(cfg.n_fast_layer):
        lp = _layer(params["fast"], l)
        kh, vh = hist[l]
        h = rms_norm(x, lp["attention_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(h, lp, cfg, tp)
        q = apply_rope_interleaved(q, cos, sin)
        k = apply_rope_interleaved(k, cos, sin)
        ks = torch.cat([kh, k.to(kh.dtype)], dim=2)
        vs = torch.cat([vh, v.to(vh.dtype)], dim=2)
        attn = gqa_attention(q, ks, vs, None, scale)
        x = _attn_out_ffn(x, attn, lp, cfg, unrounded, tp)
        new_hist.append((ks, vs))
    fast_out = rms_norm(x[:, 0, :], params["fast_norm"], cfg.norm_eps)
    w = params["fast_output"]
    if tp is not None:
        lo = codebook_idx * cfg.codebook_size if cfg.depthwise_output else 0
        hi = lo + cfg.codebook_size if cfg.depthwise_output else cfg.fast_output_size
        return tp.columns(fast_out, w, lo, hi), new_hist
    if cfg.depthwise_output:
        w = w[:, codebook_idx * cfg.codebook_size:(codebook_idx + 1) * cfg.codebook_size]
    if unrounded:
        return fast_out.float() @ w.float(), new_hist
    return (fast_out @ w).float(), new_hist


def fast_embed(params, cfg: DualARConfig, token: torch.Tensor, codebook_idx: int, tp=None):
    """Embed a sampled codebook token for the next fast step:
    (B,) int -> (B, 1, D)."""
    token = token.long()
    if cfg.depthwise_wte:
        token = token + codebook_idx * cfg.codebook_size
    if tp is not None:
        return tp.lookup(params["fast_embeddings"], token)[:, None, :]
    return params["fast_embeddings"][token][:, None, :]
