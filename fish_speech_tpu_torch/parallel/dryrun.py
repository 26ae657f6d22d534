"""Worlds of spawned ranks, laid out as one host or as several equal
ones, and the serving and train dry runs over them.

The counterpart of `__graft_entry__.dryrun_multichip` (whose
processes=2 runs two processes of local devices). Every entry point
runs on the card unless the caller passes device="cpu" (then over
gloo). `run_world(..., hosts=)` gives the ranks the host layout of
`hosts` equal hosts (`parallel.distributed.initialize_distributed`'s
local pair): each rank takes its card by its local id, and every rank
reports its `placement`. The serving half:
`serving_dryrun(dp, tp, spec)` starts a world of dp * tp ranks (spawned
processes, which import nothing of JAX or of `fish_speech_tpu`) on one
device type and backend, builds the DualAR LM on every rank from one
parameter tree (each rank takes its shard), and runs on rank 0, through
`parallel.driver`, the parts `spec` names:

* "frames": a prefill and n decode frames of an engine, with the
  gathered head's logits of every frame;
* "burst": one `prefill_rows` burst, with the state's pos and done;
* "dynamic": `generate_batch` on a dynamic engine, optionally drawing
  recorded per-row noise (`generate.frame.ReplayRowNoise`);
* "batcher": requests through a `ContinuousBatcher`, over the pipeline's
  `create_batcher` with the central vocoder where a codec is given.

It returns what rank 0 saw, and every rank's launch counts of the two
attention kernels and the JAX modules it holds (none). `server_dryrun` does the same for the server: every
rank builds the server's state (`server.main.build_state`) on a mesh,
and rank 0 serves requests through `server/core.py`.

The train half: `train_dryrun(dp, tp, spec)` builds the parameters on
every rank from one tree (each rank keeps its shard,
`train.init_train_state(mesh=)`), runs meshed steps on rank-local rows
(each host's block of every global batch through `train.shard_batch`),
optionally snapshots and resumes (at another
world, or at the same one, bit for bit), and returns rank 0's metrics,
the gathered parameters and every rank's step times, collective traffic,
peak memory and foreign modules (none). `collectives_job` holds the tp
autograd functions on one rank's slices. The tests and `chip_smoke.py`
use them.
"""

from __future__ import annotations

import multiprocessing
import queue
import socket
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

WORLD_TIMEOUT_S = 300.0


def free_port() -> int:
    """A localhost TCP port free at the time of the call."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, hosts: int, address: str, tp: int, device: str,
               backend: Optional[str], timeout_s: float, build_root: str, job: Callable,
               kwargs: dict, results) -> None:
    import torch.distributed as dist

    from fish_speech_tpu_torch.parallel.distributed import initialize_distributed, make_mesh
    from fish_speech_tpu_torch.utils.cache import setup_compilation_cache

    if device == "cpu":
        torch.set_num_threads(1)
    setup_compilation_cache(build_root)
    try:
        local = world // hosts
        initialize_distributed(address, world, rank, backend=backend, timeout_s=timeout_s,
                               local_process_id=rank % local, local_num_processes=local)
        mesh = make_mesh(world, tp, device_type="cpu" if device == "cpu" else "cuda")
        results.put((rank, True, job(mesh, **kwargs)))
    except BaseException:  # noqa: BLE001 - reported to the parent, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(dp: int, tp: int, job: Callable, *, device: str = "cuda",
              backend: Optional[str] = None, timeout_s: float = WORLD_TIMEOUT_S,
              hosts: int = 1, **kwargs) -> List:
    """Run `job(mesh, **kwargs)` on every rank of a new (dp, tp) world of
    spawned processes on this host, laid out as `hosts` equal hosts (rank
    r: host r // (dp * tp / hosts), local id the remainder), and return
    each rank's result. Raises
    with a rank's traceback where one fails, and after `timeout_s` where
    the world has not ended; every process is stopped before it returns.
    `job` is a module-level function; kwargs are pickled. device: "cuda"
    (raises without a card) or "cpu"; backend: None takes nccl on the
    card and gloo on the CPU."""
    from fish_speech_tpu_torch.device import resolve_device
    from fish_speech_tpu_torch.ops import _cuda_build

    device = resolve_device(device).type
    if device == "cpu":
        backend = backend or "gloo"
    world = dp * tp
    if hosts < 1 or world % hosts:
        raise ValueError(f"run_world: {world} ranks do not make {hosts} equal hosts")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    address = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, hosts, address, tp, device, backend, timeout_s,
                               str(_cuda_build.BUILD_ROOT), job, kwargs, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, object] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                lost = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                if lost:
                    raise RuntimeError(f"world dp={dp} tp={tp}: ranks {lost} exited with "
                                       f"{[procs[r].exitcode for r in lost]} and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"world dp={dp} tp={tp}: {sorted(got)} of {world} ranks "
                                       f"ended within {timeout_s:.0f}s") from None
                continue
            if not ok:
                raise RuntimeError(f"world dp={dp} tp={tp}: rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"world dp={dp} tp={tp}: ranks exited with {bad}")
    return [got[r] for r in range(world)]


# --------------------------------------------------------------------------
# The serving dry run
# --------------------------------------------------------------------------


def foreign_modules() -> List[str]:
    """Modules of JAX or of the JAX package in this process: a rank holds
    none (the port imports neither)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0].startswith("jax") or m.split(".")[0] == "fish_speech_tpu")


def placement(mesh) -> dict:
    """This rank's host layout, its card ("cpu" without CUDA) and its
    place in the mesh."""
    from fish_speech_tpu_torch.parallel.distributed import coords, host_layout

    c = coords(mesh)
    card = f"cuda:{torch.cuda.current_device()}" if torch.cuda.is_available() else "cpu"
    return dict(host_layout()._asdict(), card=card, dp_rank=c.dp_rank, tp_rank=c.tp_rank)


def _launch_counts() -> dict:
    from fish_speech_tpu_torch.ops import decode_attention, prefill_attention

    return {"decode_attention": decode_attention.launches,
            "prefill_attention": prefill_attention.launches}


def _reset_counts() -> None:
    from fish_speech_tpu_torch.ops import decode_attention, prefill_attention

    decode_attention.launches = prefill_attention.launches = 0


def _params(spec: dict, device: torch.device):
    from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params

    if spec.get("params") is not None:
        return dual_ar_params_from_numpy(spec["params"], device=device, dtype=spec["dtype"])
    params = init_dual_ar_params(spec["cfg"], seed=spec["seed"], dtype=spec["dtype"],
                                 device=device)
    # random weights that must not stop early: these head columns zeroed
    params["output"][:, list(spec.get("zero_head_columns", ()))] = 0
    return params


def _engine_for(base, part: dict):
    kw = part.get("engine")
    return base.sibling(**kw) if kw else base


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def run_frames(base, part: dict) -> dict:
    """A prefill of part["prompts"] (B, C+1, S) and part["n"] decode
    frames: every frame and the gathered head's logits it was drawn
    from."""
    eng = _engine_for(base, part)
    sampling = part["sampling"]
    t0 = time.perf_counter()
    state = eng.init_state(part.get("seed", 0))
    state, frame, _, hidden = eng._prefill_raw(state, part["prompts"], sampling)
    frames, logits = [_np(frame)], [_np(eng.logits(hidden))]
    for _ in range(part["n"]):
        state, frame, hidden = eng._step(state, sampling)
        frames.append(_np(frame))
        logits.append(_np(eng.logits(hidden)))
    return {"frames": np.stack(frames), "logits": np.stack(logits),
            "pos": _np(state.pos), "done": _np(state.done), "seconds": time.perf_counter() - t0}


def run_burst(base, part: dict) -> dict:
    """One `prefill_rows` burst into a fresh state."""
    eng = _engine_for(base, part)
    state = eng.init_state(part.get("seed", 0))
    state, frames, eos = eng.prefill_rows(state, part["prompts"], part["sampling"],
                                          part["row0"])
    return {"frames": _np(frames), "eos": _np(eos), "pos": _np(state.pos),
            "done": _np(state.done)}


def run_dynamic(base, part: dict) -> dict:
    """`generate_batch` of a dynamic engine; part["draws"]: recorded
    per-row draws (`ReplayRowNoise`) in place of the engine's streams."""
    from fish_speech_tpu_torch.generate.frame import ReplayRowNoise

    eng = _engine_for(base, part)
    if part.get("draws") is not None:
        rng = ReplayRowNoise(part["draws"], eng.device)
        make = eng.init_state
        eng.init_state = lambda seed=None: eng.with_rng(make(seed), rng)
    res = eng.generate_batch(part["prompts"], max_new_tokens=part["max_new"],
                             sampling=part["sampling"], seed=part.get("seed", 0))
    return {"rows": [{"semantic": r.semantic, "tokens": r.tokens, "frames": r.frames,
                      "hit_max": r.hit_max} for r in res]}


def run_batcher(base, part: dict) -> dict:
    """part["requests"] (dicts of prompts, cond_len, max_new and
    optionally sampling, seed) submitted at once to a ContinuousBatcher of
    part["rows"] rows: with part["codec"] ((FireflyConfig, seed, dtype)),
    the pipeline's create_batcher and its central vocoder (deliver_pcm),
    else a batcher over a sibling engine. Each request's chunk results
    (and PCM), the frames a second and the batcher's ticks."""
    from fish_speech_tpu_torch.generate.continuous import (
        ContinuousBatcher, _ChunkResult, _PartialPCM)

    wait = part.get("wait_s", 300.0)
    codec = None
    if part.get("codec") is not None:
        from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec, init_firefly_params
        from fish_speech_tpu_torch.pipeline import TTSPipeline

        ccfg, seed, dtype = part["codec"]
        codec = FireflyCodec(init_firefly_params(ccfg, seed=seed, dtype=dtype,
                                                 device=base.device), ccfg, device=base.device)
        pipeline = TTSPipeline(base, codec, None, base.lm)
        pipeline.default_sampling = part["sampling"]
        batcher = pipeline.create_batcher(part["rows"], part["horizon"])
    else:
        eng = base.sibling(batch_size=part["rows"], **part.get("engine", {}))
        batcher = ContinuousBatcher(eng, part["sampling"], horizon=part["horizon"])
    try:
        t0 = time.perf_counter()
        reqs = [batcher.submit(r["prompts"], r.get("cond_len", 0), r["max_new"], stream=True,
                               sampling=r.get("sampling"), seed=r.get("seed"),
                               deliver_pcm=codec is not None) for r in part["requests"]]
        out = []
        for req in reqs:
            chunks, pcm = [], []
            for ev in req.iter_events(timeout=wait):
                if isinstance(ev, _ChunkResult):
                    chunks.append({"semantic": ev.semantic, "tokens": ev.tokens,
                                   "hit_max": ev.hit_max})
                elif isinstance(ev, _PartialPCM):
                    pcm.append(ev.pcm)
            if req.error is not None:
                raise RuntimeError(f"batcher request failed: {req.error!r}")
            out.append({"chunks": chunks,
                        "pcm": np.concatenate(pcm) if pcm else None})
        seconds = time.perf_counter() - t0
    finally:
        batcher.shutdown()
    frames = sum(c["semantic"].shape[0] for r in out for c in r["chunks"])
    return {"requests": out, "seconds": seconds, "frames": frames,
            "frames_per_s": frames / seconds, "ticks": batcher.ticks,
            "samples_per_frame": None if codec is None else codec.samples_per_frame}


PARTS = {"frames": run_frames, "burst": run_burst, "dynamic": run_dynamic,
         "batcher": run_batcher}


def collective_ms(mesh, device: torch.device, rows: int = 16, width: int = 1024,
                  n: int = 20) -> dict:
    """Host ms of one all-reduce of a (rows, width) float32 tensor over the
    mesh's widest axis (tp, else dp), as the model's and the driver's
    collectives run it: on a tensor on `device`, and staged through the
    host (a copy out, the all-reduce on a CPU tensor, a copy back). Every
    rank calls it."""
    import torch.distributed as dist

    axis = "tp" if mesh.size(1) > 1 else "dp"
    group = mesh.get_group(axis)
    x = torch.ones((rows, width), dtype=torch.float32, device=device)

    def staged():
        y = x.cpu()
        dist.all_reduce(y, group=group)
        return y.to(device)

    out = {"axis": axis}
    for name, fn in (("device", lambda: dist.all_reduce(x, group=group)), ("staged", staged)):
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out[name] = (time.perf_counter() - t0) * 1e3 / n
    return out


def serving_job(mesh, spec: dict) -> dict:
    """One rank of the serving dry run (see the module docstring)."""
    import torch.distributed as dist

    from fish_speech_tpu_torch.generate.engine import LMEngine
    from fish_speech_tpu_torch.ops.quant import is_quantized
    from fish_speech_tpu_torch.parallel.driver import Driver
    from fish_speech_tpu_torch.parallel.mesh import shard_lm_params

    device = torch.device(spec["device"])
    cfg = spec["cfg"]
    if spec.get("load") is not None:
        return _loaded_serving_job(mesh, spec, device)
    params = shard_lm_params(_params(spec, device), mesh, cfg)
    engine = LMEngine(params, cfg, spec["token_cfg"], spec["lm"], dtype=spec["dtype"],
                      device=device, mesh=mesh, **spec.get("engine", {}))
    del params
    driver = Driver(mesh, timeout_s=spec.get("timeout_s", WORLD_TIMEOUT_S))
    collective = collective_ms(mesh, device) if mesh.size() > 1 else None
    _reset_counts()
    if dist.get_rank() != 0:
        calls = driver.follow(engine)
        return {"calls": calls, "launches": _launch_counts(), "foreign_modules": foreign_modules(),
                "placement": placement(mesh)}
    lead = driver.lead(engine)
    try:
        out = {name: PARTS[part.get("kind", name)](lead, part)
               for name, part in spec["parts"].items()}
    finally:
        driver.close()
    out["launches"] = _launch_counts()
    out["foreign_modules"] = foreign_modules()
    out["placement"] = placement(mesh)
    out["collective_ms"] = collective
    wqkv = engine.params["slow"]["wqkv"]
    out["local_heads"] = (wqkv["q"] if is_quantized(wqkv) else wqkv).shape[-1] // cfg.head_dim
    return out


def _loaded_serving_job(mesh, spec: dict, device: torch.device) -> dict:
    """serving_job on the pipeline every rank loads from a checkpoint
    directory, `TTSPipeline.load(spec["load"]["checkpoint"], mesh=)`:
    spec["load"] holds quantize_int8, cache_len and codec_config (the
    Firefly config of the directory's codec, in place of the version's)."""
    from fish_speech_tpu_torch.config import FireflyConfig, WhichModel
    from fish_speech_tpu_torch.ops.quant import QUANT_KEYS, is_quantized
    from fish_speech_tpu_torch.pipeline import TTSPipeline

    load = spec["load"]
    if load.get("codec_config") is not None:  # this job's own process
        FireflyConfig.for_version = staticmethod(lambda version: load["codec_config"])
    _reset_counts()
    pipeline = TTSPipeline.load(load["checkpoint"], WhichModel(load["model"]),
                                lm_dtype=spec["dtype"], cache_len=load.get("cache_len"),
                                quantize_int8=load.get("quantize_int8", False), device=device,
                                mesh=mesh)
    if pipeline is None:  # a follower: rank 0 closed the driver
        return {"calls": None, "launches": _launch_counts(), "foreign_modules": foreign_modules(),
                "placement": placement(mesh)}
    lead = pipeline.engine
    try:
        out = {name: PARTS[part.get("kind", name)](lead, part)
               for name, part in spec["parts"].items()}
    finally:
        pipeline.close()
    engine = lead._local
    wqkv = engine.params["slow"]["wqkv"]
    out.update(launches=_launch_counts(), foreign_modules=foreign_modules(),
               placement=placement(mesh), quantize_int8=engine.quantize_int8,
               quantized_stacks=all(is_quantized(engine.params[st][k])
                                    for st in ("slow", "fast") for k in QUANT_KEYS),
               local_heads=(wqkv["q"] if is_quantized(wqkv) else wqkv).shape[-1]
               // spec["cfg"].head_dim)
    return out


def serving_dryrun(dp: int, tp: int, spec: dict, *, device: str = "cuda",
                   backend: Optional[str] = None,
                   timeout_s: float = WORLD_TIMEOUT_S, hosts: int = 1) -> dict:
    """Rank 0's results of the serving dry run on a (dp, tp) world of
    `hosts` equal hosts, with "ranks": every rank's launch counts and
    placement (and the followers' call counts).
    spec: cfg, token_cfg, lm, dtype, params (a numpy tree) or seed (random
    weights, with zero_head_columns zeroed), engine (the base engine's
    keyword arguments: batch_size 1 by default), parts ({name: part}, a
    part of `PARTS[part.get("kind", name)]`), timeout_s (the driver's);
    or, in place of params, seed and engine, load: the base engine is the
    pipeline's that every rank loads (`_loaded_serving_job`)."""
    from fish_speech_tpu_torch.device import resolve_device

    spec = dict(spec, device=resolve_device(device).type)
    ranks = run_world(dp, tp, serving_job, device=device, backend=backend,
                      timeout_s=timeout_s, hosts=hosts, spec=spec)
    return dict(ranks[0], ranks=ranks)


# --------------------------------------------------------------------------
# The server on a mesh
# --------------------------------------------------------------------------


def server_job(mesh, argv: List[str], requests: List[dict], cancel: Optional[dict],
               codec_config=None) -> dict:
    """Every rank builds the server's state from `argv`
    (`server.main.build_state`) on the mesh; rank 0 answers `requests`
    (SpeechRequest bodies) through `server/core.py`'s WAV route, then
    streams `cancel` through the batcher's route and cancels it after its
    first PCM chunk, then closes the pipeline, which ends the other
    ranks' loops. codec_config: the Firefly config the checkpoint's codec
    weights have, in place of the version's (each rank is this job's own
    process)."""
    from fish_speech_tpu_torch.config import FireflyConfig
    from fish_speech_tpu_torch.server import core
    from fish_speech_tpu_torch.server.main import build_parser, build_state

    if codec_config is not None:
        FireflyConfig.for_version = staticmethod(lambda version: codec_config)
    args = build_parser().parse_args(argv)
    state = build_state(args, mesh)
    if state is None:  # a follower: rank 0 closed the driver
        return {"follower_left": True, "launches": _launch_counts()}
    out = {"pcm": []}
    try:
        for body in requests:
            req = core.SpeechRequest.parse(body, state.pipeline.default_sampling)
            out["pcm"].append(core.wav_pcm(state, req))
        if cancel is not None:
            req = core.SpeechRequest.parse(cancel, state.pipeline.default_sampling)
            submitted = []
            gen = core.pcm_chunks(state, req, on_submit=submitted.append)
            first = next(gen)
            submitted[0].cancel()
            rest = list(gen)
            breq = submitted[0]
            deadline = time.monotonic() + 60
            while breq.freed_tick is None and time.monotonic() < deadline:
                time.sleep(0.01)
            out["cancel"] = {"first_chunk": first.shape[0], "chunks_after": len(rest),
                             "cancelled": breq.cancelled, "freed": breq.freed_tick is not None}
    finally:
        if state.batcher is not None:
            state.batcher.shutdown()
        state.pipeline.close()
    out["launches"] = _launch_counts()
    return out


def server_dryrun(n: int, tp: int, argv: List[str], requests: List[dict],
                  cancel: Optional[dict] = None, codec_config=None, *, device: str = "cuda",
                  backend: Optional[str] = None,
                  timeout_s: float = WORLD_TIMEOUT_S) -> List[dict]:
    """Every rank's result of `server_job` on a world of n ranks at tp
    (`server.main`'s --shard n --tp tp) on `device` (argv's --device is
    the server's own)."""
    return run_world(n // tp, tp, server_job, device=device, backend=backend,
                     timeout_s=timeout_s, argv=argv, requests=requests, cancel=cancel,
                     codec_config=codec_config)


# --------------------------------------------------------------------------
# The train dry run
# --------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _train_params(spec: dict, cfg, device: torch.device):
    from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params

    if spec.get("params") is not None:
        return dual_ar_params_from_numpy(spec["params"], device=device, dtype=spec["dtype"])
    return init_dual_ar_params(cfg, seed=spec["seed"], dtype=spec["dtype"], device=device)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _local_state(params, opt_state) -> Dict[str, torch.Tensor]:
    """{path: tensor} of a rank's own train state."""
    from fish_speech_tpu_torch.train.step import tree_leaves

    return {"/".join(path): t for path, t in tree_leaves({"p": params, "o": opt_state})}


def _compare(params, ref, mesh, cfg, tight: float) -> dict:
    """This rank's parameter shards against its shards of the unsharded
    run's parameters `ref` ((metrics, {name: tensor})), summed over the tp
    group (a replicated leaf counted once): the reference's metrics, the
    largest difference, how many values differ by more than `tight` out
    of how many, and whether every value is bit-equal."""
    import torch.distributed as dist

    from fish_speech_tpu_torch.parallel.distributed import coords
    from fish_speech_tpu_torch.parallel.mesh import is_split, lm_param_specs, shard_leaf
    from fish_speech_tpu_torch.train.step import tree_leaves

    metrics, whole = ref
    c = coords(mesh)
    specs = dict(tree_leaves(lm_param_specs(cfg)))
    device = tree_leaves(params)[0][1].device
    worst = torch.zeros((), dtype=torch.float32, device=device)
    counts = torch.zeros(3, dtype=torch.int64, device=device)  # beyond, total, not bit-equal
    for path, g in tree_leaves(params):
        if c.tp_rank and not is_split(specs[path]):
            continue  # replicated: tp rank 0 counts it
        g = g.detach()
        r = shard_leaf(whole["/".join(path)], specs[path], cfg, c.tp_rank, c.tp).to(g.device)
        diff = (g - r).abs()
        worst = torch.maximum(worst, diff.max())
        counts += torch.stack([(diff > tight).sum(), torch.tensor(diff.numel(), device=device),
                               torch.tensor(int(not _bits_equal(g, r)), device=device)])
        del diff, r
    if c.tp > 1:
        group = mesh.get_group("tp")
        dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(counts, group=group)
    beyond, total, differ = counts.tolist()
    return {"steps": metrics, "max_abs_diff": float(worst), "beyond": beyond, "total": total,
            "bit_equal": differ == 0}


def train_job(mesh, spec: dict) -> dict:
    """One rank of the train dry run (see `train_dryrun`)."""
    import contextlib
    import io

    import torch.distributed as dist

    from fish_speech_tpu_torch.parallel import distributed as pdist
    from fish_speech_tpu_torch.train import init_train_state, make_train_step
    from fish_speech_tpu_torch.train.checkpoint import (
        gather_params, load_train_state, save_train_state)
    from fish_speech_tpu_torch.train.step import shard_batch, tree_leaves

    device = torch.device(spec["device"])
    tcfg = spec["tcfg"]
    tp = pdist.coords(mesh).tp
    host = pdist.host_layout().host

    def on_device(b):
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    def host_block(b):
        lo, hi = pdist.host_rows(b["tokens"].shape[0])
        return {k: v[lo:hi] for k, v in b.items()}

    def start(cfg, resume, mesh=mesh):
        params, opt_state = init_train_state(_train_params(spec, cfg, device), tcfg, mesh=mesh,
                                             cfg=cfg, device=device)
        if not resume:
            return 0, params, opt_state
        if isinstance(resume, list):  # one path a host, each host's view of its storage
            resume = resume[host]
        return load_train_state(resume, params, opt_state, mesh=mesh, cfg=cfg)[:3]

    def train(cfg, params, opt_state, batches, first, save=None):
        step = make_train_step(cfg, spec["token_cfg"], tcfg, mesh=mesh)
        out = []
        for i, b in enumerate(batches, start=first):
            local = shard_batch(on_device(host_block(b)), mesh)
            _sync(device)
            pdist.traffic.update(calls=0, bytes=0)
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, local)
            _sync(device)
            out.append(dict({k: float(v) for k, v in m.items()},
                            seconds=time.perf_counter() - t0, **pdist.traffic))
            if save is not None and i + 1 == save["after"]:
                save_train_state(save["path"], step=i + 1, params=params, opt_state=opt_state,
                                 mesh=mesh, cfg=cfg)
        return params, opt_state, out

    def reference(cfg, run):
        # the unsharded step on the same global batches, from the start;
        # its parameters stay on the device, its moments go
        _, params, opt_state = start(cfg, None, mesh=None)
        step = make_train_step(cfg, spec["token_cfg"], tcfg)
        metrics = []
        for b in run["reference"].get("batches") or run["batches"]:
            params, opt_state, m = step(params, opt_state, on_device(b))
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, {"/".join(p): t for p, t in tree_leaves(params)}

    result = {"runs": []}
    for run in spec["runs"]:
        cfg = run.get("cfg") or spec["cfg"]
        clock = [time.perf_counter()]

        def lap():
            _sync(device)
            clock.append(time.perf_counter())
            return clock[-1] - clock[-2]

        seconds = {}
        # every tp rank compares its own shards; without tp, rank 0 alone
        ref = (reference(cfg, run) if run.get("reference") and (tp > 1 or dist.get_rank() == 0)
               else None)
        seconds["reference"] = lap()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            held = torch.cuda.memory_allocated(device)  # the reference's parameters
        if run.get("expect_error"):
            try:
                start(cfg, run.get("resume"))
            except FileNotFoundError as e:
                result["runs"].append({"error": str(e), "seconds": lap()})
                continue
            raise RuntimeError("train_job: the run was to fail at its start, and did not")
        first, params, opt_state = start(cfg, run.get("resume"))
        seconds["start"] = lap()
        params, opt_state, steps = train(cfg, params, opt_state, run["batches"], first,
                                         run.get("save"))
        seconds["steps"] = lap()
        out = {"steps": steps, "seconds": seconds,
               "peak_bytes": (torch.cuda.max_memory_allocated(device) - held
                              if device.type == "cuda" else None)}
        if ref is not None:
            out["reference"] = _compare(params, ref, mesh, cfg, run["reference"]["tight"])
        del ref
        seconds["compare"] = lap()
        if not run.get("reference"):
            whole = gather_params(params, mesh, cfg)
            if dist.get_rank() == 0:
                out["params"] = {"/".join(p): t.detach().cpu().numpy()
                                 for p, t in tree_leaves(whole)}
            del whole
        if run.get("resume_check"):
            # the same mesh again from the run's snapshot: bit for bit the
            # run, compared shard by shard on each rank
            straight = {k: v.clone() for k, v in _local_state(params, opt_state).items()}
            del params, opt_state
            first, params, opt_state = start(cfg, run["save"]["path"])
            params, opt_state, _ = train(cfg, params, opt_state, run["batches"][first:], first)
            again = _local_state(params, opt_state)
            out["resume_differs"] = [n for n in straight if not _bits_equal(straight[n],
                                                                            again[n])]
            del straight, again
            seconds["resume_check"] = lap()
        del params, opt_state
        result["runs"].append(out)
    if spec.get("collectives") is not None:
        result["collectives"] = collectives_job(mesh, spec["collectives"])
    if spec.get("mesh_probes"):
        result["mesh_probes"] = [mesh_probe(tp, spec["runs"][0]["batches"][0], device)
                                 for tp in spec["mesh_probes"]]
    if spec.get("finetune"):
        from fish_speech_tpu_torch.cli import finetune

        printed = []
        for argv in spec["finetune"]:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                finetune.main(list(argv))
            printed.append(buf.getvalue())
        result["finetune_stdout"] = printed
    result["foreign_modules"] = foreign_modules()
    result["placement"] = placement(mesh)
    return result


def train_dryrun(dp: int, tp: int, spec: dict, *, device: str = "cuda",
                 backend: Optional[str] = None,
                 timeout_s: float = WORLD_TIMEOUT_S, hosts: int = 1) -> dict:
    """The train dry run on a (dp, tp) world of `hosts` equal hosts: rank
    0's result of `train_job`, with "ranks" every rank's (less the
    parameters). Each host feeds its block of every global batch.

    spec: cfg, token_cfg, tcfg (`train.TrainConfig`), dtype, params (a
    numpy tree in the JAX layout) or seed (`init_dual_ar_params`), and
    runs, each from fresh parameters: {"batches": global {"tokens",
    "seq_lens"} numpy batches, one a step; optionally "cfg" (the run's
    own config, with seeded parameters), "resume" (a snapshot to start
    from, or a list of one path a host: each host's view of its own
    storage), "expect_error" (the start raises FileNotFoundError on every
    rank, a rank cannot see the resume path: the run is {"error": the
    message}), "save" ({"path", "after": steps}: a snapshot after that many
    steps), "resume_check" (reload that snapshot on this world and run
    the rest again: "resume_differs" lists the names of the rank's train
    state that are not bit-equal to the run's), "reference" ({"tight":
    x, "batches": optional}: the ranks first run the unsharded step on
    "batches" (default: the run's) from fresh parameters, and the run's
    "reference" holds that run's metrics and, over the ranks' shards, the
    largest difference from it, the count of values beyond x out of how
    many, and whether all are bit-equal)}; a run without a reference
    returns its gathered parameters under "params", {path: array}.
    Optionally collectives (`collectives_job`'s inputs), mesh_probes (tp
    widths: `mesh_probe` of each on the first run's first batch) and
    finetune (argv lists, each run through `cli.finetune.main` on every
    rank; the printed text under "finetune_stdout").

    Returns "runs" (each with "steps": a step's metrics, its seconds and
    the collectives the rank sent (calls, bytes); "peak_bytes": the
    card's peak allocation during the run's steps above what the rank
    held before them (the reference's parameters); "seconds": the rank's
    time in the run's phases, the reference, the start (parameters,
    shards, a resume's load), the steps (a save included), the compare,
    the resume check), "foreign_modules" and "placement"."""
    from fish_speech_tpu_torch.device import resolve_device

    spec = dict(spec, device=resolve_device(device).type)
    ranks = run_world(dp, tp, train_job, device=device, backend=backend, timeout_s=timeout_s,
                      hosts=hosts, spec=spec)
    slim = [dict(r, runs=[{k: v for k, v in run.items() if k != "params"} for run in r["runs"]])
            for r in ranks]
    return dict(ranks[0], ranks=slim)


def mesh_probe(tp: int, batch: dict, device: torch.device) -> dict:
    """Another mesh over the world at `tp` (every rank calls it): the
    warnings `make_mesh` logged, this rank's place in it, and this rank's
    rows of the global `batch` (numpy) through `shard_batch` fed this
    host's block."""
    import logging

    from fish_speech_tpu_torch.parallel import distributed as pdist
    from fish_speech_tpu_torch.train.step import shard_batch

    class Record(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    handler = Record()
    pdist.logger.addHandler(handler)
    try:
        mesh = pdist.make_mesh(None, tp, device.type)
    finally:
        pdist.logger.removeHandler(handler)
    lo, hi = pdist.host_rows(batch["tokens"].shape[0])
    rows = shard_batch({k: torch.from_numpy(v[lo:hi]).to(device) for k, v in batch.items()},
                       mesh)
    return {"tp": tp, "warnings": handler.messages, "placement": placement(mesh),
            "rows": {k: v.cpu().numpy() for k, v in rows.items()}}


def collectives_job(mesh, inputs: dict) -> dict:
    """The tp autograd functions on this rank's slices of `inputs` (numpy
    float32: x (N, D), w (D, K), an upstream gradient gy (N, K), and a
    head's real width `width` <= K): for each of `Copy` (this rank's
    column block of x @ W, its input through tp.copy), `Reduce` (x @ W
    summed from this rank's block of D) and `GatherColumns` (tp.columns
    over [0, width)), its output and the gradients of sum(out * gy) as
    numpy, on the CPU."""
    from fish_speech_tpu_torch.parallel.mesh import TensorParallel, split_block

    tp = TensorParallel.of(mesh)
    x, w, gy = (torch.from_numpy(inputs[k]) for k in ("x", "w", "gy"))
    width = inputs["width"]

    def leaf(t):
        return t.clone().requires_grad_(True)

    def grads(out, g, *ins):
        (out * g).sum().backward()
        return {"out": out.detach().numpy(), "grads": [t.grad.numpy() for t in ins]}

    xc, wc = leaf(x), leaf(split_block(w, 1, tp.rank, tp.size))
    xr, wr = leaf(split_block(x, 1, tp.rank, tp.size)), leaf(split_block(w, 0, tp.rank, tp.size))
    xg, wg = leaf(x), leaf(split_block(w, 1, tp.rank, tp.size))
    return {
        "copy": grads(tp.copy(xc) @ wc, split_block(gy, 1, tp.rank, tp.size), xc, wc),
        "reduce": grads(tp.all_reduce(xr @ wr), gy, xr, wr),
        "columns": grads(tp.columns(xg, wg, 0, width), gy[:, :width], xg, wg),
        "foreign_modules": foreign_modules(),
    }
