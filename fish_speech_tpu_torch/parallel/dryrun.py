"""Worlds of ranks on one host, and the serving dry run over them.

The counterpart of the serving half of `__graft_entry__.dryrun_multichip`:
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
and rank 0 serves requests through `server/core.py`. The tests and
`chip_smoke.py` both use them.
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


def _rank_main(rank: int, world: int, address: str, tp: int, device: str,
               backend: Optional[str], timeout_s: float, build_root: str, job: Callable,
               kwargs: dict, results) -> None:
    import torch.distributed as dist

    from fish_speech_tpu_torch.parallel.distributed import initialize_distributed, make_mesh
    from fish_speech_tpu_torch.utils.cache import setup_compilation_cache

    if device == "cpu":
        torch.set_num_threads(1)
    setup_compilation_cache(build_root)
    try:
        initialize_distributed(address, world, rank, backend=backend, timeout_s=timeout_s)
        mesh = make_mesh(world, tp, device_type="cpu" if device == "cpu" else "cuda")
        results.put((rank, True, job(mesh, **kwargs)))
    except BaseException:  # noqa: BLE001 - reported to the parent, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(dp: int, tp: int, job: Callable, *, device: str = "cpu",
              backend: Optional[str] = None, timeout_s: float = WORLD_TIMEOUT_S,
              **kwargs) -> List:
    """Run `job(mesh, **kwargs)` on every rank of a new (dp, tp) world of
    spawned processes on this host, and return each rank's result. Raises
    with a rank's traceback where one fails, and after `timeout_s` where
    the world has not ended; every process is stopped before it returns.
    `job` is a module-level function; kwargs are pickled."""
    from fish_speech_tpu_torch.ops import _cuda_build

    world = dp * tp
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    address = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, address, tp, device, backend, timeout_s,
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
    params = shard_lm_params(_params(spec, device), mesh, cfg)
    engine = LMEngine(params, cfg, spec["token_cfg"], spec["lm"], dtype=spec["dtype"],
                      device=device, mesh=mesh, **spec.get("engine", {}))
    del params
    driver = Driver(mesh, timeout_s=spec.get("timeout_s", WORLD_TIMEOUT_S))
    collective = collective_ms(mesh, device) if mesh.size() > 1 else None
    _reset_counts()
    if dist.get_rank() != 0:
        calls = driver.follow(engine)
        return {"calls": calls, "launches": _launch_counts(), "foreign_modules": foreign_modules()}
    lead = driver.lead(engine)
    try:
        out = {name: PARTS[part.get("kind", name)](lead, part)
               for name, part in spec["parts"].items()}
    finally:
        driver.close()
    out["launches"] = _launch_counts()
    out["foreign_modules"] = foreign_modules()
    out["collective_ms"] = collective
    wqkv = engine.params["slow"]["wqkv"]
    out["local_heads"] = (wqkv["q"] if is_quantized(wqkv) else wqkv).shape[-1] // cfg.head_dim
    return out


def serving_dryrun(dp: int, tp: int, spec: dict, *, device: str = "cpu",
                   backend: Optional[str] = None,
                   timeout_s: float = WORLD_TIMEOUT_S) -> dict:
    """Rank 0's results of the serving dry run on a (dp, tp) world, with
    "ranks": every rank's launch counts (and the followers' call counts).
    spec: cfg, token_cfg, lm, dtype, params (a numpy tree) or seed (random
    weights, with zero_head_columns zeroed), engine (the base engine's
    keyword arguments: batch_size 1 by default), parts ({name: part}, a
    part of `PARTS[part.get("kind", name)]`), timeout_s (the driver's)."""
    spec = dict(spec, device=device if device == "cpu" else "cuda")
    ranks = run_world(dp, tp, serving_job, device=device, backend=backend,
                      timeout_s=timeout_s, spec=spec)
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
                  cancel: Optional[dict] = None, codec_config=None, *,
                  timeout_s: float = WORLD_TIMEOUT_S) -> List[dict]:
    """Every rank's result of `server_job` on a world of n ranks at tp
    (`server.main`'s --shard n --tp tp), on the CPU over gloo."""
    return run_world(n // tp, tp, server_job, device="cpu", backend="gloo",
                     timeout_s=timeout_s, argv=argv, requests=requests, cancel=cancel,
                     codec_config=codec_config)
