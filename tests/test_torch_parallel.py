"""The port's parallel serving on the CPU over gloo (fish_speech_tpu_torch/
parallel/): worlds of spawned ranks at (dp, tp) = (1, 2), (2, 1) and
(2, 2), each running `parallel.dryrun.serving_dryrun` once (a module-
scoped fixture), against the JAX package's unsharded engines at
test_torch_engine.py's config (4 q heads over 2 KV heads, vocab 1010),
float32 weights from `init_dual_ar_params` converted through numpy:

* a prefill and three decode frames of a 4-row engine at temp 0:
  token-exact against the JAX engine (the counterparts of
  tests/test_parallel.py's test_sharded_decode_matches_unsharded and
  test_sharded_decode_pallas_matches_xla), the gathered head's logits
  within 1e-5 relative of the port's unsharded engine's;
* a burst `prefill_rows` at row 1 (test_sharded_burst_prefill_matches_
  unsharded): frames, pos and done;
* seeded dynamic sampling on JAX's own per-row draws (`JaxRowNoise`,
  recorded and replayed in the ranks): codes exact across dp;
* the sharded continuous batcher against the serial JAX engine
  (test_sharded_continuous_batcher_matches_serial);
* the shard specs, leaf by leaf against the JAX specs, with wqkv split by
  head; `initialize_distributed`'s no-op cases and the nccl error;
* the server built with --shard 2 --tp 2 (`server_dryrun`): a request
  through server/core.py gives the unsharded server's PCM, a second one
  is cancelled mid-stream, and the follower leaves its loop at shutdown.

Every world runs with a timeout of its own, on a free port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.generate.engine import LMEngine as JaxEngine
from fish_speech_tpu.models.dual_ar import init_dual_ar_params
from fish_speech_tpu.ops.sampling import BATCHED_REP_PEN_WINDOW as JAX_WINDOW
from fish_speech_tpu.ops.sampling import SamplingArgs as JaxSampling
from fish_speech_tpu.parallel.mesh import lm_param_specs as jax_specs
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.generate.engine import LMEngine
from fish_speech_tpu_torch.generate.frame import NoiseLayout
from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy
from fish_speech_tpu_torch.ops.sampling import BATCHED_REP_PEN_WINDOW, SamplingArgs
from fish_speech_tpu_torch.parallel import distributed as tdist
from fish_speech_tpu_torch.parallel import dryrun
from fish_speech_tpu_torch.parallel import mesh as tmesh
from test_torch_dynamic_sampling import JaxRowNoise
from test_torch_engine import KW, TOK, VOCAB

torch.set_num_threads(1)

WORLDS = [(1, 2), (2, 1), (2, 2)]
WORLD_TIMEOUT_S = 120
B = 4
C = KW["num_codebooks"]
BASE = dict(batch_size=1, cache_len=32, max_frames=8, prompt_buckets=(8,))
ARGMAX = dict(temp=0.0, top_p=0.8, top_k=256, repetition_penalty=1.4)
SAMPLED = dict(temp=0.8, top_p=0.9, top_k=32, repetition_penalty=1.3)
DYN_LENS = (5, 7, 3, 8)
DYN_NEW = 6
N_STEPS = 3


def _prompt(rng, n):
    return np.concatenate([rng.integers(10, VOCAB, (1, n)),
                           rng.integers(0, KW["codebook_size"], (C, n))]).astype(np.int32)


@pytest.fixture(scope="module")
def setup():
    jc = jcfg.DualARConfig(**{**KW, "vocab_size": VOCAB})
    tc = tcfg.DualARConfig(**{**KW, "vocab_size": VOCAB})
    params = jax.jit(init_dual_ar_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jc, jnp.float32)
    # a zero im_end column: generations run their length
    params["output"] = params["output"].at[:, TOK["im_end_id"]].set(0.0)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(1)
    inputs = dict(
        batch=np.stack([_prompt(rng, 6) for _ in range(B)]),
        burst=[_prompt(rng, 4 + i) for i in range(3)],
        dynamic=[_prompt(rng, n) for n in DYN_LENS],
        serial=[_prompt(rng, n) for n in (6, 4, 7)],
    )
    return jc, tc, params, tree, inputs


def _jax_engine(jc, params, **kw):
    kw = {**dict(BASE, max_frames=4, attention_impl="xla"), **kw}
    return JaxEngine(params, jc, jcfg.TokenConfig(**TOK), jcfg.WhichLM.FISH_1_5,
                     dtype=jnp.float32, prefill_impl="xla", slow_impl="xla",
                     fast_frame_impl="xla", **kw)


def _dyn_layout(tc):
    head = 1 + tc.codebook_size  # im_end and the semantic range
    return NoiseLayout.of(tcfg.WhichLM.FISH_1_5, tc, head, 256)


def _recorded_draws(tc, seed, frames):
    """JaxRowNoise's first `frames` draws of each of B rows, as numpy
    (semantic, codebooks) pairs a frame."""
    noise = JaxRowNoise(B, seed)
    per_frame = [noise.frame(range(B), _dyn_layout(tc)) for _ in range(frames)]
    return [[(f.semantic[r].numpy(), f.codebooks[r].numpy()) for f in per_frame]
            for r in range(B)]


def _spec(tc, tree, inputs):
    argmax = SamplingArgs(**ARGMAX)
    return dict(
        cfg=tc, token_cfg=tcfg.TokenConfig(**TOK), lm=tcfg.WhichLM.FISH_1_5,
        dtype=torch.float32, params=tree, engine=BASE, timeout_s=WORLD_TIMEOUT_S,
        parts={
            "frames": dict(engine=dict(batch_size=B), prompts=inputs["batch"], n=N_STEPS,
                           sampling=argmax, seed=7),
            "burst": dict(engine=dict(batch_size=B), prompts=inputs["burst"], row0=1,
                          sampling=argmax, seed=7),
            "dynamic": dict(engine=dict(batch_size=B, dynamic_sampling=True,
                                        rep_pen_window=BATCHED_REP_PEN_WINDOW),
                            prompts=inputs["dynamic"], max_new=DYN_NEW,
                            sampling=SamplingArgs(**SAMPLED), seed=3,
                            draws=_recorded_draws(tc, 3, DYN_NEW)),
            "batcher": dict(rows=B, horizon=3, sampling=argmax,
                            requests=[dict(prompts=[p], max_new=5) for p in inputs["serial"]]),
            "seeded": dict(kind="batcher", **_seeded_batcher(inputs)),
        })


def _seeded_batcher(inputs):
    """Seeded sampled requests through a dynamic 4-row batcher: the first
    burst's rows can all lie on one dp rank."""
    return dict(rows=B, horizon=3, sampling=SamplingArgs(**ARGMAX),
                engine=dict(dynamic_sampling=True, rep_pen_window=BATCHED_REP_PEN_WINDOW),
                requests=[dict(prompts=[p], max_new=6, sampling=SamplingArgs(**SAMPLED),
                               seed=40 + i) for i, p in enumerate(inputs["serial"])])


def _int8_tree(tree):
    """The tree with its stacks quantized whole (the port's quantizer), as
    numpy: what a quantized checkpoint gives every rank to shard."""
    from fish_speech_tpu_torch.ops.quant import quantize_lm_params

    def np_tree(t):
        if isinstance(t, dict):
            return {k: np_tree(v) for k, v in t.items()}
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()

    return np_tree(quantize_lm_params(dual_ar_params_from_numpy(tree)))


@pytest.fixture(scope="module")
def worlds(setup):
    """Rank 0's results of one world a (dp, tp), and of a tp = 2 world on
    the int8 tree ("int8")."""
    _, tc, _, tree, inputs = setup
    spec = _spec(tc, tree, inputs)
    out = {w: dryrun.serving_dryrun(*w, spec, timeout_s=WORLD_TIMEOUT_S) for w in WORLDS}
    int8 = dict(spec, params=_int8_tree(tree), parts={"frames": spec["parts"]["frames"]})
    out["int8"] = dryrun.serving_dryrun(1, 2, int8, timeout_s=WORLD_TIMEOUT_S)
    return out


@pytest.fixture(scope="module")
def references(setup):
    """The JAX engines' results, unsharded, and the port's unsharded
    frames and logits."""
    jc, tc, params, tree, inputs = setup
    out = {}
    sampling = JaxSampling(**ARGMAX)
    for impl in ("xla", "pallas"):  # the decode kernel in interpret mode
        eng = _jax_engine(jc, params, batch_size=B, attention_impl=impl)
        state = eng.init_state(seed=7)
        state, frame, _ = eng.prefill(state, inputs["batch"], sampling)
        frames = [np.asarray(frame)]
        step = eng._get_step(sampling)
        for _ in range(N_STEPS):
            state, f = step(state)
            frames.append(np.asarray(f))
        out["frames_" + impl] = np.stack(frames)

    state = eng.init_state(seed=7)
    state, f, _ = eng.prefill_rows(state, inputs["burst"], sampling, row0=1)
    out["burst"] = (np.asarray(f), np.asarray(state.pos), np.asarray(state.done))

    dyn = _jax_engine(jc, params, batch_size=B, rep_pen_window=JAX_WINDOW,
                      dynamic_sampling=True, max_frames=8)
    out["dynamic"] = dyn.generate_batch(inputs["dynamic"], max_new_tokens=DYN_NEW,
                                        sampling=JaxSampling(**SAMPLED), seed=3)

    serial = _jax_engine(jc, params, max_frames=8)
    out["serial"] = [serial.generate(p, max_new_tokens=5, sampling=sampling, seed=0)[0]
                     for p in inputs["serial"]]

    port = LMEngine(dual_ar_params_from_numpy(tree), tc, tcfg.TokenConfig(**TOK),
                    tcfg.WhichLM.FISH_1_5, dtype=torch.float32, device="cpu",
                    **dict(BASE, batch_size=B))
    out["port"] = dryrun.run_frames(port, dict(prompts=inputs["batch"], n=N_STEPS,
                                               sampling=SamplingArgs(**ARGMAX), seed=7))
    port8 = LMEngine(dual_ar_params_from_numpy(_int8_tree(tree)), tc, tcfg.TokenConfig(**TOK),
                     tcfg.WhichLM.FISH_1_5, dtype=torch.float32, device="cpu",
                     **dict(BASE, batch_size=B))
    out["int8"] = dryrun.run_frames(port8, dict(prompts=inputs["batch"], n=N_STEPS,
                                                sampling=SamplingArgs(**ARGMAX), seed=7))
    port1 = LMEngine(dual_ar_params_from_numpy(tree), tc, tcfg.TokenConfig(**TOK),
                     tcfg.WhichLM.FISH_1_5, dtype=torch.float32, device="cpu", **BASE)
    out["seeded"] = dryrun.run_batcher(port1, _seeded_batcher(inputs))
    return out


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"dp{w[0]}tp{w[1]}")
def test_sharded_decode_matches_jax(worlds, references, world):
    got = worlds[world]["frames"]
    np.testing.assert_array_equal(got["frames"], references["frames_xla"])
    np.testing.assert_array_equal(got["frames"], references["frames_pallas"])
    ref = references["port"]["logits"]
    np.testing.assert_allclose(got["logits"], ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_tp_on_an_int8_tree_matches_unsharded(worlds, references):
    """A tree quantized whole, sharded at tp = 2 (scales split with the
    columns, whole for wo and w2): the unsharded int8 engine's tokens,
    logits within 1e-5 relative."""
    got, ref = worlds["int8"]["frames"], references["int8"]
    np.testing.assert_array_equal(got["frames"], ref["frames"])
    np.testing.assert_allclose(got["logits"], ref["logits"], rtol=1e-5,
                               atol=1e-5 * np.abs(ref["logits"]).max())


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"dp{w[0]}tp{w[1]}")
def test_sharded_burst_prefill_matches_jax(worlds, references, world):
    got = worlds[world]["burst"]
    frames, pos, done = references["burst"]
    np.testing.assert_array_equal(got["frames"], frames)
    np.testing.assert_array_equal(got["pos"], pos)
    np.testing.assert_array_equal(got["done"], done)


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"dp{w[0]}tp{w[1]}")
def test_sharded_dynamic_sampling_matches_jax_draws(worlds, references, world):
    got = worlds[world]["dynamic"]["rows"]
    for g, r in zip(got, references["dynamic"]):
        np.testing.assert_array_equal(g["semantic"], r.semantic)
        np.testing.assert_array_equal(g["tokens"], r.tokens)
        assert (g["frames"], g["hit_max"]) == (r.frames, r.hit_max)


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"dp{w[0]}tp{w[1]}")
def test_sharded_continuous_batcher_matches_serial(worlds, references, world):
    got = worlds[world]["batcher"]["requests"]
    assert len(got) == len(references["serial"])
    for g, r in zip(got, references["serial"]):
        assert len(g["chunks"]) == 1
        np.testing.assert_array_equal(g["chunks"][0]["semantic"], r.semantic)
        np.testing.assert_array_equal(g["chunks"][0]["tokens"], r.tokens)


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"dp{w[0]}tp{w[1]}")
def test_sharded_seeded_batcher_matches_unsharded(worlds, references, world):
    """Seeded sampled requests through the dynamic batcher: each one's
    codes equal the unsharded port batcher's, whichever rank holds its
    row."""
    got = worlds[world]["seeded"]["requests"]
    ref = references["seeded"]["requests"]
    for g, r in zip(got, ref):
        for gc, rc in zip(g["chunks"], r["chunks"]):
            np.testing.assert_array_equal(gc["semantic"], rc["semantic"])
            np.testing.assert_array_equal(gc["tokens"], rc["tokens"])


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"dp{w[0]}tp{w[1]}")
def test_world_shards_and_counts(worlds, world):
    """Each rank holds its own q and KV heads (2 and 1 at tp 2), every
    rank ran the attention functions, and the followers ran every call
    and left their loops."""
    r0 = worlds[world]
    dp, tp = world
    assert r0["local_heads"] == (KW["n_head"] + 2 * KW["n_local_heads"]) // tp
    assert len(r0["ranks"]) == dp * tp
    calls = [r["calls"] for r in r0["ranks"][1:]]
    assert calls and len(set(calls)) == 1 and calls[0] > 0
    for r in r0["ranks"]:
        assert r["launches"] == {"decode_attention": 0, "prefill_attention": 0}  # CPU: plain


# -- specs ------------------------------------------------------------------


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


SPEC_LEAVES = [path for path, _ in _leaves(tmesh.lm_param_specs(tcfg.DualARConfig(**KW)))]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("path", SPEC_LEAVES, ids=lambda p: ".".join(p))
def test_shard_spec_of_each_leaf(setup, path):
    """The port's spec equals JAX's but for wqkv, which is split by head;
    the two tp = 2 shards of the leaf rebuild it."""
    jc, tc, _, tree, _ = setup
    spec = _at(tmesh.lm_param_specs(tc), path)
    jspec = tuple(_at(jax_specs(jc), path))
    full = torch.from_numpy(np.array(_at(tree, path)))
    shards = [tmesh.shard_leaf(full, spec, tc, r, 2) for r in range(2)]
    if path[-1] == "wqkv":
        assert jspec == (None, None, "tp") and spec == (None, None, "tp_heads")
        hd, h, kv = tc.head_dim, tc.n_head, tc.n_local_heads
        heads = full.reshape(*full.shape[:-1], h + 2 * kv, hd)
        for r, s in enumerate(shards):
            want = torch.cat([heads[..., r * h // 2:(r + 1) * h // 2, :],
                              heads[..., h + r * kv // 2:h + (r + 1) * kv // 2, :],
                              heads[..., h + kv + r * kv // 2:h + kv + (r + 1) * kv // 2, :]],
                             dim=-2)
            torch.testing.assert_close(s, want.reshape(s.shape), rtol=0, atol=0)
        return
    assert spec == tuple(jspec)
    axis = next((i for i, n in enumerate(spec) if n == "tp"), None)
    if axis is None:
        for s in shards:
            torch.testing.assert_close(s, full, rtol=0, atol=0)
        return
    whole = torch.cat(shards, dim=axis).narrow(axis, 0, full.shape[axis])
    torch.testing.assert_close(whole, full, rtol=0, atol=0)
    assert shards[0].shape[axis] == -(-full.shape[axis] // 2)


class _Coords:
    """A mesh's coordinates without processes: (dp, tp) sizes and this
    rank's place."""

    def __init__(self, dp, tp, dp_rank, tp_rank):
        self.shape, self.ranks = (dp, tp), {"dp": dp_rank, "tp": tp_rank}

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, name):
        return self.ranks[name]


@pytest.mark.parametrize("name", ["wqkv", "wo", "w1", "w3", "w2"])
def test_shard_of_an_int8_tree(setup, name):
    """A tree quantized whole, then sharded: q splits like the dense
    weight, the per-column scales split with the columns (wqkv by head)
    and stay whole for the row-split weights, so each shard dequantizes
    to its slice of the whole weight's dequantization."""
    from fish_speech_tpu_torch.ops.quant import dequantize_weight, quantize_lm_params

    _, tc, _, tree, _ = setup
    full = quantize_lm_params(dual_ar_params_from_numpy(tree))
    spec = tmesh.lm_param_specs(tc)["slow"][name]
    whole = dequantize_weight(full["slow"][name])
    for r in range(2):
        shard = tmesh.shard_lm_params(full, _Coords(1, 2, 0, r), tc)["slow"][name]
        if name in ("wo", "w2"):
            torch.testing.assert_close(shard["s"], full["slow"][name]["s"], rtol=0, atol=0)
        want = tmesh.shard_leaf(whole, spec, tc, r, 2)
        torch.testing.assert_close(dequantize_weight(shard), want, rtol=0, atol=0)


def test_shard_gen_state_takes_rows_and_kv_heads(setup):
    """A whole state's slice for rank (dp 1, tp 1) of a 2 x 2 mesh: rows
    2-3 and KV head 1 of the cache, rows 2-3 of every other field."""
    _, tc, _, tree, _ = setup

    eng = LMEngine(dual_ar_params_from_numpy(tree), tc, tcfg.TokenConfig(**TOK),
                   tcfg.WhichLM.FISH_1_5, dtype=torch.float32, device="cpu",
                   **dict(BASE, batch_size=B, dynamic_sampling=True))
    state = eng.init_state(5)
    state = state._replace(pos=torch.arange(B, dtype=torch.int32),
                           cache=state.cache._replace(k=torch.randn(state.cache.k.shape)))
    local = tmesh.shard_gen_state(state, _Coords(2, 2, 1, 1), tc)
    assert local.cache.k.shape == (tc.n_layer, 2, 1, 32, tc.head_dim)
    torch.testing.assert_close(local.cache.k, state.cache.k[:, 2:4, 1:2])
    assert local.pos.tolist() == [2, 3]
    assert local.samp.temp.shape == (2,) and len(local.rng.generators) == 2
    assert local.rng.generators[0] is state.rng.generators[2]


# -- initialize_distributed ------------------------------------------------


@pytest.fixture
def no_world_env(monkeypatch):
    for var in (tdist.COORDINATOR_ENV, tdist.NUM_PROCESSES_ENV, tdist.PROCESS_ID_ENV):
        monkeypatch.delenv(var, raising=False)


def test_initialize_is_noop_without_coordinator(no_world_env):
    assert tdist.initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def test_initialize_is_noop_with_only_the_counts(no_world_env, monkeypatch):
    """The process count and id without a coordinator: still single-process."""
    monkeypatch.setenv(tdist.NUM_PROCESSES_ENV, "2")
    monkeypatch.setenv(tdist.PROCESS_ID_ENV, "0")
    assert tdist.initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def test_initialize_needs_the_counts_with_a_coordinator(no_world_env):
    with pytest.raises(ValueError, match="number of processes"):
        tdist.initialize_distributed("127.0.0.1:1")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("backend", ["nccl", None])
def test_nccl_refuses_ranks_sharing_a_card(no_world_env, monkeypatch, backend):
    """Two ranks and one card: nccl (asked for, or the default where
    CUDA is available) raises, naming gloo; nothing is initialised."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        tdist.initialize_distributed("127.0.0.1:1", 2, 1, backend=backend)
    assert not torch.distributed.is_initialized()


def test_local_rows():
    assert tdist.local_rows(16, _Coords(2, 1, 1, 0)) == (8, 16)
    assert tdist.local_rows(1, _Coords(2, 1, 1, 0)) == (0, 1)  # batch 1: whole on each rank
    assert tdist.local_rows(4, None) == (0, 4)


# -- the server ------------------------------------------------------------


def test_server_shard2_tp2_serves_cancels_and_stops(ckpt, pipes, tmp_path):  # noqa: F811
    """--shard 2 --tp 2: the server's state built on every rank; a request
    through the batcher's WAV route gives the unsharded server's PCM, a
    second one, streamed by ticks, is cancelled after its first PCM and
    its row freed, and the follower leaves its loop when rank 0 closes."""
    import json
    import shutil

    from fish_speech_tpu_torch.server import core
    from fish_speech_tpu_torch.server.voices import load_speaker_prompts
    from test_torch_checkpoint import codec_cfgs

    _, tp_pipe, _ = pipes
    shutil.copy(ckpt / "voice.npy", tmp_path / "default.npy")
    (tmp_path / "index.json").write_text(json.dumps({"speakers": {"default": "hello"}}))
    body = dict(input="hello world . the provided text out .", seed=3, max_new_tokens=6,
                **{"temperature": 0.0, "top_p": 0.8, "top_k": 256, "repetition_penalty": 1.4})
    argv = ["--checkpoint", str(ckpt), "--device", "cpu", "--continuous-batch", "2",
            "--shard", "2", "--tp", "2", "--voice-dir", str(tmp_path)]
    cancel = dict(body, input="speak the text hello world . " * 4, max_new_tokens=40,
                  stream_chunk_frames=16)
    ranks = dryrun.server_dryrun(2, 2, argv, [body], cancel, codec_config=codec_cfgs("1.5")[1],
                                 timeout_s=WORLD_TIMEOUT_S)
    assert ranks[1]["follower_left"]
    got = ranks[0]
    assert got["cancel"]["cancelled"] and got["cancel"]["freed"]
    assert got["cancel"]["first_chunk"] > 0

    batcher = tp_pipe.create_batcher(rows=2, horizon=16)
    try:
        voices, voice = load_speaker_prompts(tmp_path, tp_pipe.prompt_encoder,
                                             tp_pipe.engine.cfg.num_codebooks)
        state = core.AppState(tp_pipe, voices, voice, batcher=batcher)
        ref = core.wav_pcm(state, core.SpeechRequest.parse(body, tp_pipe.default_sampling))
    finally:
        batcher.shutdown()
    assert got["pcm"][0].shape == ref.shape and ref.shape[0] > 0
    np.testing.assert_allclose(got["pcm"][0], ref, rtol=0, atol=1e-6)


from test_torch_cli import ckpt  # noqa: E402,F401 - the shared checkpoint fixture
from test_torch_pipeline import pipes  # noqa: E402,F401


def test_server_shard_flags_start_the_other_ranks(monkeypatch):
    """--shard N without a coordinator: ranks 1..N-1 are this server with
    the same flags and their FISH_TPU_* variables (processes recorded,
    not started)."""
    from fish_speech_tpu_torch.server import main as server_main

    args = server_main.build_parser().parse_args(["--shard", "4", "--tp", "2", "--backend",
                                                  "gloo"])
    assert (args.shard, args.tp, args.backend) == (4, 2, "gloo")
    started = []
    monkeypatch.setattr(server_main.subprocess, "Popen",
                        lambda cmd, env: started.append((cmd, env)))
    address, procs = server_main.launch_ranks(3, ["--shard", "3"])
    assert len(procs) == len(started) == 2
    for rank, (cmd, env) in enumerate(started, start=1):
        assert cmd[-3:] == ["fish_speech_tpu_torch.server.main", "--shard", "3"]
        assert (env[tdist.COORDINATOR_ENV], env[tdist.NUM_PROCESSES_ENV],
                env[tdist.PROCESS_ID_ENV]) == (address, "3", str(rank))
