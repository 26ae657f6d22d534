"""DualAR training step (finetuning): the port of
`fish_speech_tpu/train/step.py` on one device.

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
on the device, for the caller to read when it logs. Sharding the batch
and the parameters over a mesh (`shard_batch`, `init_train_state`'s mesh)
is the training slice still to come; `parallel/` shards serving only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import torch

from fish_speech_tpu_torch.config import DualARConfig, TokenConfig
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
    def update(self, grads: List[torch.Tensor], state: Dict, params) -> torch.Tensor:
        """Apply one step in place to `params` and `state`, given the
        gradients of tree_leaves(params) in that order. Returns the global
        norm of the gradients before clipping."""
        t = self.tcfg
        leaves = tree_leaves(params)
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
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


def init_train_state(params: Dict, tcfg: TrainConfig, device=None):
    """(params, opt_state) on `device` (default: where the parameters
    lie); the moments start at zero and the count at 0."""
    if device is not None:
        params = tree_like(params, [t.to(device) for _, t in tree_leaves(params)])
    return params, make_optimizer(tcfg).init(params)


def make_train_step(cfg: DualARConfig, token_cfg: TokenConfig,
                    tcfg: TrainConfig) -> Callable:
    """step(params, opt_state, batch) -> (params, opt_state, metrics):
    one optimizer step, in place. batch: {"tokens": (B, C+1, S),
    "seq_lens": (B,)} on the parameters' device."""
    opt = make_optimizer(tcfg)

    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        live = [t.detach().requires_grad_(True) for _, t in leaves]
        loss, metrics = dual_ar_loss(tree_like(params, live), cfg, token_cfg, batch,
                                     fast_weight=tcfg.fast_weight, remat=tcfg.remat)
        grads = torch.autograd.grad(loss, live)
        del live, loss
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = opt.update(list(grads), opt_state, params)
        return params, opt_state, metrics

    return step
