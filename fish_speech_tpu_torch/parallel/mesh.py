"""Parameter and state shards of the DualAR LM on a (dp, tp) mesh, and the
collectives of its tensor-parallel layers.

Counterpart of `fish_speech_tpu/parallel/mesh.py`. Axes:

  "dp": data parallel, the rows of the KV cache and decode state;
  "tp": tensor parallel, attention heads and the FFN hidden axis. The GQA
        KV-head count (2 for the Fish models) bounds useful tp.

The specs are Megatron's, as in JAX: wqkv/w1/w3 split by column, wo/w2
by row (an all-reduce after each), the embeddings and heads over the
vocab (a masked local lookup, then an all-reduce). A split axis of a
size tp does not divide is padded with zeros at its end. One entry
differs from JAX: JAX splits the fused wqkv's (H + 2 KV) * hd columns
down the middle (`P(None, None, "tp")`, which at Fish-1.5 gives rank 0 q
heads 0-9 and rank 1 q heads 10-15 with all of k and v) and GSPMD
reshards; explicit collectives cannot, so wqkv is split by head
("tp_heads"): rank r takes its own q heads, k heads and v heads, in that
order.

The collectives are autograd functions, Megatron's conjugate pairs
(GSPMD derives them in JAX): `Reduce` (the all-reduce after a row-split
product or a vocab-split lookup; its backward passes the gradient on),
`Copy` (on the replicated input of a column-split product; the identity,
whose backward all-reduces the gradient, so the residual stream, the
norm scales and the embeddings get the whole gradient and not one
rank's part) and `GatherColumns` (a column-split head's logits gathered
by an all-reduce into zeros; its backward keeps this rank's columns).
Each returns a new tensor, so a training step differentiates the
sharded model; under inference mode they are the plain collectives.

Pipeline, sequence and expert parallelism are absent, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.ops.quant import is_quantized
from fish_speech_tpu_torch.parallel.distributed import all_reduce, coords, local_rows

Spec = Tuple[Optional[str], ...]  # per axis: None (whole), "tp" or "tp_heads"


def lm_param_specs(cfg: DualARConfig) -> Dict:
    """The split of every leaf of the DualAR parameter tree."""
    stack = {
        "wqkv": (None, None, "tp_heads"),
        "wo": (None, "tp", None),
        "w1": (None, None, "tp"),
        "w3": (None, None, "tp"),
        "w2": (None, "tp", None),
        "attention_norm": (None, None),
        "ffn_norm": (None, None),
    }
    return {
        "embeddings": ("tp", None),
        "codebook_embeddings": ("tp", None),
        "fast_embeddings": ("tp", None),
        "norm": (None,),
        "fast_norm": (None,),
        "output": (None, "tp"),
        "fast_output": (None, "tp"),
        "slow": dict(stack),
        "fast": dict(stack),
    }


def lm_param_shapes(cfg: DualARConfig) -> Dict:
    """The whole shape of every leaf of the DualAR parameter tree."""
    d, f, hd = cfg.dim, cfg.ffn_dim, cfg.head_dim

    def stack(n):
        return {"wqkv": (n, d, (cfg.n_head + 2 * cfg.n_local_heads) * hd),
                "wo": (n, cfg.n_head * hd, d), "w1": (n, d, f), "w3": (n, d, f),
                "w2": (n, f, d), "attention_norm": (n, d), "ffn_norm": (n, d)}

    return {
        "embeddings": (cfg.vocab_size, d),
        "codebook_embeddings": (cfg.codebook_size * cfg.num_codebooks, d),
        "fast_embeddings": (cfg.fast_vocab_size, d),
        "norm": (d,),
        "fast_norm": (d,),
        "output": (d, cfg.vocab_size),
        "fast_output": (d, cfg.fast_output_size),
        "slow": stack(cfg.n_layer),
        "fast": stack(cfg.n_fast_layer),
    }


def is_split(spec: Spec) -> bool:
    """Whether a leaf of this spec is divided over tp (else replicated)."""
    return any(name is not None for name in spec)


def check_divisible(cfg: DualARConfig, tp: int) -> None:
    """What the JAX kernel's shard_map asserts (attention_pallas.py:172-181):
    tp divides the q and KV head counts."""
    if cfg.n_head % tp or cfg.n_local_heads % tp:
        raise ValueError(f"heads ({cfg.n_head} q, {cfg.n_local_heads} kv) not divisible by "
                         f"tp={tp}")


def split_block(x: torch.Tensor, axis: int, rank: int, size: int) -> torch.Tensor:
    """Block `rank` of `size` equal blocks of x along axis, the last ones
    padded with zeros where size does not divide it."""
    n = -(-x.shape[axis] // size)
    part = x.narrow(axis, min(rank * n, x.shape[axis]),
                    max(0, min(n, x.shape[axis] - rank * n)))
    pad = n - part.shape[axis]
    if pad:
        shape = list(x.shape)
        shape[axis] = pad
        part = torch.cat([part, x.new_zeros(shape)], dim=axis)
    return part


def _head_blocks(cfg: DualARConfig, rank: int, size: int) -> Tuple[Tuple[int, int], ...]:
    """(first head, heads) of this rank's q, k and v blocks in a fused
    wqkv's (H + 2 KV) heads."""
    check_divisible(cfg, size)
    h, kv = cfg.n_head, cfg.n_local_heads
    hl, kvl = h // size, kv // size
    return (rank * hl, hl), (h + rank * kvl, kvl), (h + kv + rank * kvl, kvl)


def split_heads(x: torch.Tensor, cfg: DualARConfig, rank: int, size: int) -> torch.Tensor:
    """This rank's columns of a fused (..., (H + 2 KV) * hd) wqkv: its q
    heads, then its k heads, then its v heads."""
    hd = cfg.head_dim
    return torch.cat([x[..., s * hd:(s + n) * hd] for s, n in _head_blocks(cfg, rank, size)],
                     dim=-1)


def shard_leaf(x: torch.Tensor, spec: Spec, cfg: DualARConfig, rank: int,
               size: int) -> torch.Tensor:
    """This rank's slice of one leaf (a contiguous copy)."""
    for axis, name in enumerate(spec):
        if name == "tp":
            x = split_block(x, axis, rank, size)
        elif name == "tp_heads":
            x = split_heads(x, cfg, rank, size)
    return x.contiguous()


def unshard_leaf(x: torch.Tensor, spec: Spec, cfg: DualARConfig, rank: int, size: int,
                 shape: Tuple[int, ...]) -> torch.Tensor:
    """The inverse of `shard_leaf` on one rank: a zero tensor of the
    leaf's whole `shape` holding this rank's slice `x` where it came from
    (its padding left out, split_heads undone). Its sum over the ranks is
    the whole leaf."""
    out = x.new_zeros(shape)
    for axis, name in enumerate(spec):
        if name == "tp":
            n = x.shape[axis]
            lo = min(rank * n, shape[axis])
            k = min(n, shape[axis] - lo)
            out.narrow(axis, lo, k).copy_(x.narrow(axis, 0, k))
            return out
        if name == "tp_heads":
            hd, at = cfg.head_dim, 0
            for s0, n in _head_blocks(cfg, rank, size):
                out[..., s0 * hd:(s0 + n) * hd] = x[..., at:at + n * hd]
                at += n * hd
            return out
    return x.clone()


def gather_leaf(x: torch.Tensor, spec: Spec, cfg: DualARConfig, mesh,
                shape: Tuple[int, ...]) -> torch.Tensor:
    """The whole leaf of shape `shape` from every tp rank's slice, on each
    of them: `unshard_leaf`, then an all-reduce over tp of its bits as
    integers, which is exact (every element is one rank's bits plus
    zeros; a negative zero and a NaN keep theirs). A replicated leaf is
    returned as it is."""
    c = coords(mesh)
    if c.tp == 1 or not is_split(spec):
        return x
    full = unshard_leaf(x, spec, cfg, c.tp_rank, c.tp, shape)
    if full.dtype == torch.float32:
        bits = full.view(torch.int32)
    elif full.element_size() == 2 and full.is_floating_point():
        bits = full.view(torch.int16).to(torch.int32)
    else:
        bits = full.to(torch.int64)
    all_reduce(bits, mesh.get_group("tp"))
    if full.dtype == torch.float32:
        return bits.view(torch.float32)
    if full.element_size() == 2 and full.is_floating_point():
        return bits.to(torch.int16).view(full.dtype)
    return bits.to(full.dtype)


def _shard_tree(tree, specs, cfg, rank, size):
    if is_quantized(tree):
        # the int8 weight splits like the dense one; its per-column scales
        # (.., 1, out) split with the columns and not over the rows
        scale_spec = specs[:-2] + (None,) + specs[-1:]
        return {"q": shard_leaf(tree["q"], specs, cfg, rank, size),
                "s": shard_leaf(tree["s"], scale_spec, cfg, rank, size)}
    if isinstance(specs, dict):
        return {k: _shard_tree(tree[k], specs[k], cfg, rank, size) for k in specs}
    return shard_leaf(tree, specs, cfg, rank, size)


def shard_lm_params(params: Dict, mesh, cfg: DualARConfig) -> Dict:
    """This rank's slices of a full DualAR tree (the converter's or the
    checkpoint reader's), per `lm_param_specs`. Without tp (or without a
    mesh) the tree is returned as it is."""
    c = coords(mesh)
    if c.tp == 1:
        return params
    check_divisible(cfg, c.tp)
    return _shard_tree(params, lm_param_specs(cfg), cfg, c.tp_rank, c.tp)


def gen_state_specs(cfg: DualARConfig, per_row_rng: bool = False):
    """The split of every GenState field: rows over dp, the cache's KV
    heads over tp (cache layout (L, B, KV, S, hd)). per_row_rng: a
    dynamic engine's per-row noise streams split with the rows."""
    from fish_speech_tpu_torch.generate.engine import GenState
    from fish_speech_tpu_torch.models.dual_ar import KVCache
    from fish_speech_tpu_torch.ops.sampling import RepPenWindow, RowSampling

    return GenState(
        cache=KVCache(k=(None, "dp", "tp", None, None), v=(None, "dp", "tp", None, None)),
        pos=("dp",),
        prev=("dp", None),
        rep_pen=RepPenWindow(tokens=("dp", None, None), ptr=()),
        rng=("dp",) if per_row_rng else (),
        done=("dp",),
        samp=RowSampling(temp=("dp",), top_p=("dp",), top_k=("dp",), rep_pen=("dp",)),
    )


def shard_gen_state(state, mesh, cfg: DualARConfig):
    """This rank's part of a whole GenState: its rows (where dp divides
    the batch) and its KV heads of the cache."""
    from fish_speech_tpu_torch.generate.engine import GenState
    from fish_speech_tpu_torch.models.dual_ar import KVCache
    from fish_speech_tpu_torch.ops.sampling import RepPenWindow, RowSampling

    c = coords(mesh)
    lo, hi = local_rows(state.pos.shape[0], mesh)
    per_row = hasattr(state.rng, "rows")
    specs = gen_state_specs(cfg, per_row_rng=per_row)

    def take(x, spec):
        for axis, name in enumerate(spec):
            if name == "dp":
                x = x.narrow(axis, lo, hi - lo)
            elif name == "tp":
                check_divisible(cfg, c.tp)
                x = split_block(x, axis, c.tp_rank, c.tp)
        return x.contiguous()

    return GenState(
        cache=KVCache(k=take(state.cache.k, specs.cache.k), v=take(state.cache.v, specs.cache.v)),
        pos=take(state.pos, specs.pos),
        prev=take(state.prev, specs.prev),
        rep_pen=RepPenWindow(tokens=take(state.rep_pen.tokens, specs.rep_pen.tokens),
                             ptr=state.rep_pen.ptr),
        rng=state.rng.rows(lo, hi) if per_row else state.rng,
        done=take(state.done, specs.done),
        samp=RowSampling(*(take(t, s) for t, s in zip(state.samp, specs.samp))),
    )


class Reduce(torch.autograd.Function):
    """The sum over a tp group (in float32 for floating tensors, returned
    in x's dtype), as a new tensor; the backward passes the gradient on:
    each rank's loss depends on the sum alone."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.to(torch.float32, copy=True) if x.is_floating_point() else x.clone()
        all_reduce(y, group)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Copy(torch.autograd.Function):
    """The identity on a replicated activation that feeds a column-split
    product; the backward sums the gradient's partials over the tp group
    (each rank's product saw only its own columns)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        y = g.to(torch.float32, copy=True)
        all_reduce(y, ctx.group)
        return y.to(g.dtype), None


class GatherColumns(torch.autograd.Function):
    """A (..., k) float32 block of columns placed at `offset` in a (...,
    width) zero tensor, summed over the tp group: every rank's columns,
    exact (one rank's value plus zeros). The backward keeps this rank's
    block of the gradient, with no collective."""

    @staticmethod
    def forward(ctx, local, offset, width, group):
        ctx.offset, ctx.k = offset, local.shape[-1]
        out = local.new_zeros((*local.shape[:-1], width))
        out[..., offset:offset + ctx.k] = local
        all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.offset:ctx.offset + ctx.k], None, None, None


class TensorParallel:
    """The collectives of the model's tensor-parallel layers on one rank
    of a tp group of `size` ranks (`models/dual_ar.py` takes one as `tp`;
    None runs unsharded). Sums run in float32 for floating tensors; each
    is an autograd function (see the module docstring)."""

    def __init__(self, group, size: int, rank: int) -> None:
        self.group, self.size, self.rank = group, size, rank

    @staticmethod
    def of(mesh) -> Optional["TensorParallel"]:
        """The mesh's tp axis, or None where it has one rank."""
        c = coords(mesh)
        return None if c.tp == 1 else TensorParallel(mesh.get_group("tp"), c.tp, c.tp_rank)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the group (the partial products of a row-split
        weight), in x's dtype (`Reduce`)."""
        return Reduce.apply(x, self.group)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """x, whose gradient is summed over the group (`Copy`): the input
        of a column-split product."""
        return Copy.apply(x, self.group)

    def local_lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows `ids` of a vocab-split table of which this rank holds rows
        [rank * n, (rank + 1) * n): its own rows, zeros elsewhere. Their
        all-reduce is the lookup, exact (one rank's value plus zeros)."""
        n = table.shape[0]
        local = ids.long() - self.rank * n
        mine = (local >= 0) & (local < n)
        rows = F.embedding(local.clamp(0, n - 1), table)
        return torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                               device=rows.device))

    def lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(self.local_lookup(table, ids))

    def columns(self, x: torch.Tensor, w: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """(x @ W)[..., lo:hi] in float32 for a column-split W of which this
        rank holds columns [rank * n, (rank + 1) * n) as w: its own
        columns, gathered by an all-reduce into zeros (exact;
        `GatherColumns`). x is replicated (`Copy`)."""
        n = w.shape[1]
        a, b = max(lo, self.rank * n), min(hi, (self.rank + 1) * n)
        b = max(a, b)
        local = (self.copy(x) @ w[:, a - self.rank * n:b - self.rank * n]).float()
        return GatherColumns.apply(local, a - lo, hi - lo, self.group)

    def gather_columns(self, w: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """Columns `cols` (global indices) of a column-split (D, V) weight,
        whole on every rank: the engine's head gather. In w's dtype."""
        return self.lookup(w.T.contiguous(), cols).T.contiguous()
