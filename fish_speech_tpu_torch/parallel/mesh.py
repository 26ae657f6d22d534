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

Pipeline, sequence and expert parallelism are absent, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.ops.quant import is_quantized
from fish_speech_tpu_torch.parallel.distributed import coords, local_rows

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


def split_heads(x: torch.Tensor, cfg: DualARConfig, rank: int, size: int) -> torch.Tensor:
    """This rank's columns of a fused (..., (H + 2 KV) * hd) wqkv: its q
    heads, then its k heads, then its v heads."""
    check_divisible(cfg, size)
    hd, h, kv = cfg.head_dim, cfg.n_head, cfg.n_local_heads
    hl, kvl = h // size, kv // size
    starts = ((rank * hl, hl), (h + rank * kvl, kvl), (h + kv + rank * kvl, kvl))
    return torch.cat([x[..., s * hd:(s + n) * hd] for s, n in starts], dim=-1)


def shard_leaf(x: torch.Tensor, spec: Spec, cfg: DualARConfig, rank: int,
               size: int) -> torch.Tensor:
    """This rank's slice of one leaf (a contiguous copy)."""
    for axis, name in enumerate(spec):
        if name == "tp":
            x = split_block(x, axis, rank, size)
        elif name == "tp_heads":
            x = split_heads(x, cfg, rank, size)
    return x.contiguous()


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


class TensorParallel:
    """The collectives of the model's tensor-parallel layers on one rank
    of a tp group of `size` ranks (`models/dual_ar.py` takes one as `tp`;
    None runs unsharded). Sums run in float32 for floating tensors."""

    def __init__(self, group, size: int, rank: int) -> None:
        self.group, self.size, self.rank = group, size, rank

    @staticmethod
    def of(mesh) -> Optional["TensorParallel"]:
        """The mesh's tp axis, or None where it has one rank."""
        c = coords(mesh)
        return None if c.tp == 1 else TensorParallel(mesh.get_group("tp"), c.tp, c.tp_rank)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the group (the partial products of a row-split
        weight), in x's dtype."""
        y = x.float() if x.is_floating_point() else x.clone()
        dist.all_reduce(y, group=self.group)
        return y.to(x.dtype)

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
        columns, gathered by an all-reduce into zeros (exact)."""
        n = w.shape[1]
        a, b = max(lo, self.rank * n), min(hi, (self.rank + 1) * n)
        out = torch.zeros((*x.shape[:-1], hi - lo), dtype=torch.float32, device=x.device)
        if a < b:
            out[..., a - lo:b - lo] = (x @ w[:, a - self.rank * n:b - self.rank * n]).float()
        dist.all_reduce(out, group=self.group)
        return out

    def gather_columns(self, w: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """Columns `cols` (global indices) of a column-split (D, V) weight,
        whole on every rank: the engine's head gather. In w's dtype."""
        return self.lookup(w.T.contiguous(), cols).T.contiguous()
