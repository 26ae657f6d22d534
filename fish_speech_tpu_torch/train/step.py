"""DualAR training step (finetuning): the port of
`fish_speech_tpu/train/step.py`, on one device or a (dp, tp) mesh of
ranks.

One step: loss -> gradients (autograd) -> clip to the global norm ->
AdamW with a linear-warmup cosine-decay learning rate -> parameter
update. The arithmetic is optax's, written out on the parameter trees:

* clip: `g` if `norm < grad_clip`, else `g / norm * grad_clip`
  (`optax.clip_by_global_norm`; `torch.nn.utils.clip_grad_norm_`
  divides by `norm + 1e-6`, which is not this rule);
* AdamW: `mu = (1 - b1) g + b1 mu`, `nu = (1 - b2) g^2 + b2 nu`, bias
  correction at count + 1, `mu_hat / (sqrt(nu_hat + 0) + 1e-8)`, then the
  decoupled weight decay `+ weight_decay * p` on every leaf whose path
  holds no norm key (the embeddings and heads are decayed: the JAX
  optimizer's mask exempts only the norm scales, whatever its comment
  says), then times `-lr`; the first moment is kept in float32 whatever
  the parameters' dtype, the second in the parameters' dtype;
* the learning rate is `optax.warmup_cosine_decay_schedule(0, lr,
  warmup, max(total, warmup + 1), lr * min_lr_ratio)` read at the count
  before it is incremented, so step 0 runs at a learning rate of 0.

The step updates the parameters and the optimizer state in place and
returns them (the JAX step donates its inputs); its metrics stay tensors
on the device, for the caller to read when it logs.

Under a mesh (one process a rank, `parallel/`), `init_train_state`
shards the parameters by `parallel.mesh.lm_param_specs` and makes the
moments on the shards, `shard_batch` gives each rank its dp rows of the
rows each host feeds, and the
step sums every gradient over dp after the backward (the psum XLA
inserts in JAX); the tp collectives are the model's own
(`parallel/mesh.py`). The clip's global norm is the norm of the whole
gradient: the squares of the tp-split leaves summed over tp, the
replicated leaves counted once, the zero padding adding nothing. AdamW
stays elementwise on the shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from fish_speech_tpu_torch.config import DualARConfig, TokenConfig
from fish_speech_tpu_torch.parallel.distributed import all_reduce, coords, host_local_to_global
from fish_speech_tpu_torch.parallel.mesh import is_split, lm_param_specs, shard_lm_params
from fish_speech_tpu_torch.train.loss import dual_ar_loss

# Leaves under any of these keys are not weight-decayed (the JAX mask).
NO_DECAY_KEYS = ("norm", "fast_norm", "attention_norm", "ffn_norm")
ADAM_EPS = 1e-8  # optax's eps; its eps_root is 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    fast_weight: float = 1.0
    remat: bool = True


def tree_leaves(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, tensor) of every leaf of a nested dict, in the order JAX
    flattens it (keys sorted at every level)."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out += tree_leaves(value, prefix + (key,))
        else:
            out.append((prefix + (key,), value))
    return out


def tree_like(tree, leaves):
    """A tree of tree's structure holding `leaves` in tree_leaves order."""
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it) for k in sorted(t)}

    return build(tree)


def decays(path: Tuple[str, ...]) -> bool:
    """Whether AdamW decays the leaf at `path`."""
    return not any(k in NO_DECAY_KEYS for k in path)


def learning_rate(tcfg: TrainConfig, count: torch.Tensor) -> torch.Tensor:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1), lr * min_lr_ratio) at `count` (an integer tensor), in
    float32 on count's device, in optax's order of operations."""
    peak = tcfg.learning_rate
    end = peak * tcfg.min_lr_ratio
    warmup = tcfg.warmup_steps
    decay_steps = max(tcfg.total_steps, warmup + 1) - warmup
    alpha = 0.0 if peak == 0.0 else end / peak
    if warmup > 0:
        frac = 1 - torch.clamp(count, 0, warmup).float() / warmup
        warm = (0.0 - peak) * frac + peak
    else:
        warm = torch.zeros((), dtype=torch.float32, device=count.device)
    done = torch.clamp((count - warmup).float(), max=float(decay_steps))
    cosine = 0.5 * (1 + torch.cos(math.pi * done / decay_steps))
    decayed = peak * ((1 - alpha) * cosine + alpha)
    return torch.where(count < warmup, warm, decayed)


class AdamW:
    """optax.chain(clip_by_global_norm, adamw(schedule, mask=...)) of the
    JAX optimizer. State: {"count": int32 scalar, "mu": tree (float32),
    "nu": tree (the parameters' dtype)}."""

    def __init__(self, tcfg: TrainConfig) -> None:
        self.tcfg = tcfg

    def init(self, params) -> Dict:
        leaves = tree_leaves(params)
        device = leaves[0][1].device
        return {
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": tree_like(params, [torch.zeros_like(t, dtype=torch.float32)
                                      for _, t in leaves]),
            "nu": tree_like(params, [torch.zeros_like(t) for _, t in leaves]),
        }

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict, params,
               norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply one step in place to `params` and `state`, given the
        gradients of tree_leaves(params) in that order. norm: their global
        norm (`global_norm`; by default that of `grads` alone). Returns the
        global norm of the gradients before clipping."""
        t = self.tcfg
        leaves = tree_leaves(params)
        if norm is None:
            norm = global_norm(grads)
        keep = norm < t.grad_clip
        count = state["count"]
        count_inc = count + 1
        lr = learning_rate(t, count)
        steps = count_inc.float()
        mu_fix = 1 - torch.pow(t.beta1, steps)
        nu_fix = 1 - torch.pow(t.beta2, steps)
        mus = [m for _, m in tree_leaves(state["mu"])]
        nus = [v for _, v in tree_leaves(state["nu"])]
        for (path, p), g, mu, nu in zip(leaves, grads, mus, nus):
            g = torch.where(keep, g, g / norm.to(g.dtype) * t.grad_clip)
            mu.copy_((1 - t.beta1) * g + t.beta1 * mu)
            nu.copy_((1 - t.beta2) * (g * g) + t.beta2 * nu)
            u = (mu / mu_fix) / (torch.sqrt(nu / nu_fix.to(nu.dtype)) + ADAM_EPS)
            if decays(path):
                u = u + t.weight_decay * p
            p.copy_(p + (-lr).to(u.dtype) * u)
        count.copy_(count_inc)
        return norm


def make_optimizer(tcfg: TrainConfig) -> AdamW:
    return AdamW(tcfg)


def global_norm(grads: List[torch.Tensor], split: Optional[List[bool]] = None,
                tp_group=None) -> torch.Tensor:
    """optax.global_norm of the whole gradient. split / tp_group: under tp,
    which leaves are this rank's slices of a tp-split leaf; their squares
    are summed over the group, the replicated leaves' counted once."""
    if tp_group is None:
        return torch.sqrt(sum(torch.sum(g * g) for g in grads))
    sq = [torch.sum(g.float() * g.float()) for g in grads]
    parts = all_reduce(torch.stack([q for q, s in zip(sq, split) if s]).sum(), tp_group)
    return torch.sqrt(parts + sum(q for q, s in zip(sq, split) if not s))


def _mesh_groups(mesh) -> Tuple[Optional[object], Optional[object]]:
    """(dp group, tp group) of a mesh, each None where its axis has one rank."""
    c = coords(mesh)
    return (mesh.get_group("dp") if c.dp > 1 else None,
            mesh.get_group("tp") if c.tp > 1 else None)


def split_leaves(cfg: DualARConfig) -> List[bool]:
    """For the tree_leaves of a DualAR tree: whether each leaf is tp-split
    (`parallel.mesh.lm_param_specs`)."""
    return [is_split(s) for _, s in tree_leaves(lm_param_specs(cfg))]


def init_train_state(params: Dict, tcfg: TrainConfig, mesh=None,
                     cfg: Optional[DualARConfig] = None, device=None):
    """(params, opt_state) on `device` (default: where the parameters
    lie); the moments start at zero and the count at 0. mesh: the (dp,
    tp) mesh this rank belongs to; `params` is the whole tree, and this
    rank keeps its tp shard (by `lm_param_specs`, which needs `cfg`), on
    which the moments are made."""
    if device is not None:
        params = tree_like(params, [t.to(device) for _, t in tree_leaves(params)])
    if mesh is not None:
        if cfg is None:
            raise ValueError("init_train_state: sharding over a mesh needs the model config")
        params = shard_lm_params(params, mesh, cfg)
    return params, make_optimizer(tcfg).init(params)


def shard_batch(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's dp rows of a {"tokens": (B, C+1, S), "seq_lens": (B,)}
    batch of this host's rows, as JAX's multi-process `shard_batch` takes
    them: the global batch is B x hosts, every host's rows in host order,
    and the rank keeps its dp block of it
    (`parallel.distributed.host_local_to_global`). On one host the batch
    is the global one and the rank keeps block dp_rank of dp. B must be a
    multiple of the host's dp ranks (JAX's assertion)."""
    return {k: host_local_to_global(v, mesh).contiguous() for k, v in batch.items()}


def make_train_step(cfg: DualARConfig, token_cfg: TokenConfig,
                    tcfg: TrainConfig, mesh=None) -> Callable:
    """step(params, opt_state, batch) -> (params, opt_state, metrics):
    one optimizer step, in place. batch: {"tokens": (B, C+1, S),
    "seq_lens": (B,)} on the parameters' device. mesh: the parameters
    and state are this rank's (`init_train_state(mesh=)`) and the batch
    its rows (`shard_batch`); the metrics are the global batch's and
    grad_norm the whole gradient's norm, the same on every rank."""
    opt = make_optimizer(tcfg)
    dp_group, tp_group = _mesh_groups(mesh) if mesh is not None else (None, None)
    split = split_leaves(cfg) if tp_group is not None else None

    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        live = [t.detach().requires_grad_(True) for _, t in leaves]
        loss, metrics = dual_ar_loss(tree_like(params, live), cfg, token_cfg, batch,
                                     fast_weight=tcfg.fast_weight, remat=tcfg.remat,
                                     mesh=mesh)
        grads = list(torch.autograd.grad(loss, live))
        del live, loss
        metrics = {k: v.detach() for k, v in metrics.items()}
        if dp_group is not None:
            # the psum over dp: each rank's loss is its part of the global mean
            for i, g in enumerate(grads):
                y = all_reduce(g.to(torch.float32), dp_group)
                grads[i] = y.to(g.dtype)
        norm = None if tp_group is None else global_norm(grads, split, tp_group)
        metrics["grad_norm"] = opt.update(grads, opt_state, params, norm)
        return params, opt_state, metrics

    return step
