"""Mid-run training snapshots, so that an interrupted finetune resumes
bit for bit: the port of `fish_speech_tpu/train/checkpoint.py`.

A snapshot holds the parameters, the optimizer state (the AdamW moments
and the step count that drives the learning-rate schedule), the step,
the numpy data-order RNG's `bit_generator.state` and a JSON `extra` (the
finetune CLI keeps its epoch permutation there). It is one `.npz`,
written atomically (a temporary file, then `os.replace`).

The format is the port's own. Each tensor is stored under its path in
the tree (`p/slow/wqkv`, `o/mu/slow/wqkv`, `o/count`), bfloat16 as its
int16 bits; the names, shapes and dtypes of both trees are stored beside
them and checked at load against templates made by the caller
(`init_train_state`), so a snapshot of another model or optimizer is
refused with ValueError instead of loaded into the wrong leaves. Each
tensor is loaded onto its template's device.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from fish_speech_tpu_torch.train.step import tree_like, tree_leaves

MAGIC = "fish_tpu_torch_train_state_v1"


def _named(prefix: str, tree) -> List[Tuple[str, torch.Tensor]]:
    return [("/".join((prefix,) + path), t) for path, t in tree_leaves(tree)]


def _spec(named) -> List[list]:
    return [[name, list(t.shape), str(t.dtype).removeprefix("torch.")] for name, t in named]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(a: np.ndarray, template: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    if template.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(template.device)


def _rng_state(rng: Optional[np.random.Generator]) -> Optional[dict]:
    # a dict of ints and a name; PCG64's 128-bit ints are plain JSON ints
    return None if rng is None else rng.bit_generator.state


def _restore_rng(state: Optional[dict]) -> Optional[np.random.Generator]:
    if state is None:
        return None
    bitgen = getattr(np.random, state["bit_generator"])()
    bitgen.state = state
    return np.random.Generator(bitgen)


def save_train_state(path: str | Path, *, step: int, params, opt_state,
                     rng: Optional[np.random.Generator] = None,
                     extra: Optional[Dict[str, Any]] = None) -> None:
    """Atomically write {params, opt_state, step, rng, extra} to `path`.
    `extra` must be JSON-serialisable. Call it between steps: the
    tensors are copied to the host as they are written."""
    path = Path(path)
    p_named = _named("p", params)
    o_named = _named("o", opt_state)
    meta = {
        "magic": MAGIC,
        "step": int(step),
        "params": _spec(p_named),
        "opt_state": _spec(o_named),
        "rng_state": _rng_state(rng),
        "extra": extra or {},
    }
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
                 **{name: _to_numpy(t) for name, t in p_named + o_named})
    os.replace(tmp, path)


def load_train_state(path: str | Path, params_template, opt_state_template
                     ) -> Tuple[int, Any, Any, Optional[np.random.Generator], Dict[str, Any]]:
    """Load a snapshot written by save_train_state into trees shaped as
    the templates, each tensor on its template's device. Raises
    ValueError when the snapshot's names, shapes or dtypes differ from the
    templates'. Returns (step, params, opt_state, rng or None, extra)."""
    p_named = _named("p", params_template)
    o_named = _named("o", opt_state_template)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("magic") != MAGIC:
            raise ValueError(f"{path}: not a train state of the port")
        for what, named in (("params", p_named), ("opt_state", o_named)):
            want = _spec(named)
            if meta[what] != want:
                diff = next(((a, b) for a, b in zip(meta[what], want) if a != b),
                            (len(meta[what]), len(want)))
                raise ValueError(
                    f"{path}: the {what} tree differs from the template (a checkpoint of "
                    f"another model or optimizer?): saved {diff[0]}, template {diff[1]}")
        params = tree_like(params_template, [_from_numpy(z[name], t) for name, t in p_named])
        opt_state = tree_like(opt_state_template,
                              [_from_numpy(z[name], t) for name, t in o_named])
    return (meta["step"], params, opt_state, _restore_rng(meta.get("rng_state")),
            meta.get("extra", {}))
