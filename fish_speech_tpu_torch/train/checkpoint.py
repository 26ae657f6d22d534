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

Under a (dp, tp) mesh (`mesh=`, `cfg=`), the snapshot holds the whole
tensors all the same: the save gathers each tp-split leaf of the
parameters and moments to its full shape (`parallel.mesh.gather_leaf`,
exact), global rank 0 writes, and the other ranks wait at a barrier; the
load reads the whole tensors and gives each rank its shard by the
specs. So a snapshot written at one mesh resumes at another or on one
device, and the other way round, as in JAX.

In a world across hosts every rank loads from the same path, so the
snapshot must lie on storage that every host sees, as the JAX loader
needs too. `load_train_state` asks every rank first (`visible`): where
one cannot see the file, every rank raises, naming the ranks, their
hosts and the path, instead of one rank failing and the others waiting
in a collective until the timeout.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from fish_speech_tpu_torch.parallel.distributed import coords, host_layout, rank0
from fish_speech_tpu_torch.parallel.mesh import (
    gather_leaf, lm_param_shapes, lm_param_specs, shard_leaf)
from fish_speech_tpu_torch.train.step import tree_like, tree_leaves

MAGIC = "fish_tpu_torch_train_state_v1"


def _named(prefix: str, tree) -> List[Tuple[str, torch.Tensor]]:
    return [("/".join((prefix,) + path), t) for path, t in tree_leaves(tree)]


def _layouts(cfg, named) -> Dict[str, Tuple[tuple, tuple]]:
    """(tp split spec, whole shape) of every snapshot name of a DualAR
    train state: a moment's leaf splits as its parameter, the count is
    whole."""
    specs = dict(tree_leaves(lm_param_specs(cfg)))
    shapes = dict(tree_leaves(lm_param_shapes(cfg)))
    out = {}
    for name, t in named:
        path = tuple(name.split("/")[1:])
        if path[0] in ("mu", "nu"):
            path = path[1:]
        out[name] = (specs[path], shapes[path]) if path in specs else ((), tuple(t.shape))
    return out


def _sharded(mesh) -> bool:
    return mesh is not None and coords(mesh).tp > 1


def _spec(named, layouts=None) -> List[list]:
    return [[name, list(t.shape if layouts is None else layouts[name][1]),
             str(t.dtype).removeprefix("torch.")] for name, t in named]


def gather_params(params, mesh, cfg) -> Dict:
    """The whole DualAR parameter tree from a rank's tp shard, on every
    rank of its tp group (each of them calls this); the tree itself
    without tp."""
    if not _sharded(mesh):
        return params
    layouts = _layouts(cfg, _named("p", params))
    return tree_like(params, [gather_leaf(t, layouts[n][0], cfg, mesh, layouts[n][1])
                              for n, t in _named("p", params)])


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(a: np.ndarray, template: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    if template.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t


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
                     extra: Optional[Dict[str, Any]] = None, mesh=None, cfg=None) -> None:
    """Atomically write {params, opt_state, step, rng, extra} to `path`.
    `extra` must be JSON-serialisable. Call it between steps: the
    tensors are copied to the host as they are written. mesh / cfg: the
    trees are a rank's shard of a DualAR train state on that mesh; every
    rank calls this, the tp-split leaves are gathered whole, global rank
    0 writes and every rank returns once the file is in place."""
    path = Path(path)
    named = _named("p", params) + _named("o", opt_state)
    layouts = _layouts(cfg, named) if _sharded(mesh) else None
    arrays = {}
    for name, t in named:
        if layouts is not None:
            t = gather_leaf(t, layouts[name][0], cfg, mesh, layouts[name][1])
        if rank0():
            arrays[name] = _to_numpy(t)
    if rank0():
        meta = {
            "magic": MAGIC,
            "step": int(step),
            "params": _spec(_named("p", params), layouts),
            "opt_state": _spec(_named("o", opt_state), layouts),
            "rng_state": _rng_state(rng),
            "extra": extra or {},
        }
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
                     **arrays)
        os.replace(tmp, path)
    if mesh is not None:
        torch.distributed.barrier()


def visible(path: str | Path, mesh=None) -> List[bool]:
    """Whether each rank of the world sees a file at `path`, by rank (one
    all-reduce over the world, which every rank calls); without a mesh,
    whether this process does."""
    here = os.path.exists(path)
    if mesh is None:
        return [here]
    seen = torch.zeros(torch.distributed.get_world_size(), dtype=torch.int64,
                       device=mesh.device_type)
    seen[torch.distributed.get_rank()] = int(here)
    torch.distributed.all_reduce(seen)
    return [bool(v) for v in seen.tolist()]


def load_train_state(path: str | Path, params_template, opt_state_template, mesh=None, cfg=None
                     ) -> Tuple[int, Any, Any, Optional[np.random.Generator], Dict[str, Any]]:
    """Load a snapshot written by save_train_state into trees shaped as
    the templates, each tensor on its template's device. Raises
    ValueError when the snapshot's names, shapes or dtypes differ from the
    templates'. mesh / cfg: the templates are a rank's shard
    (`init_train_state(mesh=)`); the snapshot holds the whole tensors, of
    whatever mesh wrote it, and each rank takes its shard; every rank of
    the world calls it, and every one raises FileNotFoundError where some
    rank cannot see `path`. Returns (step, params, opt_state, rng or
    None, extra)."""
    if mesh is not None:
        blind = [r for r, v in enumerate(visible(path, mesh)) if not v]
        if blind:
            local = host_layout().local_count
            raise FileNotFoundError(
                f"load_train_state: rank(s) {blind} on host(s) "
                f"{sorted({r // local for r in blind})} cannot see {path}; every rank loads the "
                "snapshot, so it must lie on storage that every host sees")
    p_named = _named("p", params_template)
    o_named = _named("o", opt_state_template)
    layouts = _layouts(cfg, p_named + o_named) if _sharded(mesh) else None
    c = coords(mesh)

    def load(z, name, template):
        t = _from_numpy(z[name], template)
        if layouts is not None:
            t = shard_leaf(t, layouts[name][0], cfg, c.tp_rank, c.tp)
        return t.to(template.device)

    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("magic") != MAGIC:
            raise ValueError(f"{path}: not a train state of the port")
        for what, named in (("params", p_named), ("opt_state", o_named)):
            want = _spec(named, layouts)
            if meta[what] != want:
                diff = next(((a, b) for a, b in zip(meta[what], want) if a != b),
                            (len(meta[what]), len(want)))
                raise ValueError(
                    f"{path}: the {what} tree differs from the template (a checkpoint of "
                    f"another model or optimizer?): saved {diff[0]}, template {diff[1]}")
        params = tree_like(params_template, [load(z, name, t) for name, t in p_named])
        opt_state = tree_like(opt_state_template, [load(z, name, t) for name, t in o_named])
    return (meta["step"], params, opt_state, _restore_rng(meta.get("rng_state")),
            meta.get("extra", {}))
