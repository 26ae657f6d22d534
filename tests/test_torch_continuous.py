"""The port's ContinuousBatcher (generate/continuous.py) on a tiny float32
config on the CPU, after tests/test_continuous.py: argmax requests equal
the serial batch-1 engine's codes, requests overflow the rows and queue,
multi-chunk requests keep their row and rewind to their conditioning,
pipelined speculation leaks no frames, shutdown and scheduler death
release every waiter, and a seeded request's codes do not depend on its
co-tenants. Every wait has a timeout."""

import sys
import threading
import types

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.generate.continuous import (
    BatchedRequest, ContinuousBatcher, _ChunkResult, _PartialFrames, _RowState)
from fish_speech_tpu_torch.generate.engine import LMEngine
from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params
from fish_speech_tpu_torch.ops.sampling import BATCHED_REP_PEN_WINDOW, SamplingArgs

torch.set_num_threads(1)

CFG = tcfg.DualARConfig(vocab_size=300, n_layer=2, n_fast_layer=2, n_head=4, dim=64,
                        intermediate_size=128, n_local_heads=2, head_dim=16, rope_base=1e4,
                        norm_eps=1e-6, max_seq_len=128, codebook_size=128, num_codebooks=4)
TOK = tcfg.TokenConfig(im_end_id=9, pad_id=5, semantic_start_id=10, semantic_end_id=137)
ARGMAX = SamplingArgs(temp=0.0)
SAMPLED = SamplingArgs(temp=0.8, top_p=0.9, top_k=16, repetition_penalty=1.3)
WAIT = 60.0  # seconds any single wait may take before the test fails


def make_prompt(n, shift=0):
    rng = np.random.default_rng(n + 100 * shift)
    return np.concatenate([rng.integers(10, 138, (1, n)),
                           rng.integers(0, 128, (4, n))]).astype(np.int32)


@pytest.fixture(scope="module")
def params():
    p = init_dual_ar_params(CFG, seed=0, dtype=torch.float32, device="cpu")
    p["output"][:, TOK.im_end_id] = 0  # rows run their budget unless stopped
    return p


def _engine(params, batch):
    return LMEngine(params, CFG, TOK, tcfg.WhichLM.FISH_1_5, batch_size=batch, cache_len=64,
                    max_frames=16, prompt_buckets=(16,), dtype=torch.float32, device="cpu",
                    rep_pen_window=BATCHED_REP_PEN_WINDOW, dynamic_sampling=True)


def _serial(params, prompts, cond_len, max_new):
    """Codes of a request generated alone on a batch-1 engine, argmax,
    rewinding to the conditioning length between chunks."""
    serial = LMEngine(params, CFG, TOK, tcfg.WhichLM.FISH_1_5, cache_len=64, max_frames=16,
                      prompt_buckets=(16,), dtype=torch.float32, device="cpu",
                      rep_pen_window=BATCHED_REP_PEN_WINDOW)
    state, outs, cl = serial.init_state(0), [], 0
    for i, p in enumerate(prompts):
        res, state = serial.generate(p, max_new_tokens=max_new, sampling=ARGMAX, state=state,
                                     conditioning_offset=cl if i > 0 else 0)
        cl = cond_len if i == 0 else cl
        state = serial.rewind(state, cl)
        outs.append((res.semantic, res.tokens))
    return outs


def _run(batcher, reqs):
    """Submit (prompts, cond_len, max_new, kwargs) requests from threads;
    returns their chunk lists in order."""
    results = {}

    def worker(i):
        prompts, cond_len, max_new, kw = reqs[i]
        results[i] = list(batcher.submit(prompts, cond_len, max_new, **kw)
                          .iter_chunks(timeout=WAIT))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * WAIT)
    assert not any(t.is_alive() for t in threads), "a client is still waiting"
    return [results[i] for i in range(len(reqs))]


@pytest.fixture
def batcher(params):
    b = ContinuousBatcher(_engine(params, 3), SAMPLED, horizon=4)
    yield b
    b.shutdown()


def test_batcher_matches_serial_argmax(params):
    """Argmax requests (per-request sampling on the dynamic engine)
    beside sampled co-tenants give the serial engine's codes."""
    prompts = [make_prompt(7), make_prompt(9)]
    refs = [_serial(params, [p], 0, 10)[0] for p in prompts]
    b = ContinuousBatcher(_engine(params, 3), SAMPLED, horizon=3)
    try:
        outs = _run(b, [([prompts[0]], 0, 10, dict(sampling=ARGMAX)),
                        ([make_prompt(5)], 0, 8, {}),
                        ([prompts[1]], 0, 10, dict(sampling=ARGMAX, stream=True))])
    finally:
        b.shutdown()
    for (sem, tok), chunks in zip(refs, (outs[0], outs[2])):
        assert len(chunks) == 1
        np.testing.assert_array_equal(chunks[0].semantic, sem)
        np.testing.assert_array_equal(chunks[0].tokens, tok)


def test_concurrent_requests_overflow_rows(batcher):
    """Twelve requests from threads through three rows, with ragged
    prompts, chunk counts, budgets and streaming, and a short thread
    switch interval: every request gets one result per chunk, within its
    budget and in the legal ranges."""
    rng = np.random.default_rng(11)
    reqs = []
    for i in range(12):
        n_chunks = int(rng.integers(1, 4))
        reqs.append(([make_prompt(int(rng.integers(3, 12)), i) for _ in range(n_chunks)],
                     int(rng.integers(0, 3)) if n_chunks > 1 else 0, int(rng.integers(2, 8)),
                     dict(stream=bool(i % 2))))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        outs = _run(batcher, reqs)
    finally:
        sys.setswitchinterval(interval)
    for (prompts, _, max_new, _), chunks in zip(reqs, outs):
        assert len(chunks) == len(prompts)
        for c in chunks:
            t = c.tokens.shape[1]
            assert c.tokens.shape[0] == CFG.num_codebooks and 1 <= t <= max_new
            assert c.semantic.shape == (t,)
            assert ((c.semantic >= TOK.semantic_start_id)
                    & (c.semantic <= TOK.semantic_end_id)).all()
            assert ((c.tokens >= 0) & (c.tokens < CFG.codebook_size)).all()


def test_multi_chunk_request_keeps_row_and_conditioning(params):
    """Chunks 2+ are admitted into the request's own row at the
    conditioning offset, so its cached prefix is there: argmax codes
    equal the serial engine's with its rewind, while another request
    holds the other row."""
    prompts = [make_prompt(8), make_prompt(5, 1), make_prompt(6, 2)]
    ref = _serial(params, prompts, 3, 5)
    b = ContinuousBatcher(_engine(params, 2), ARGMAX, horizon=4)
    try:
        outs = _run(b, [(prompts, 3, 5, {}), ([make_prompt(9)], 0, 12, {})])
    finally:
        b.shutdown()
    assert len(outs[0]) == 3
    for (sem, tok), chunk in zip(ref, outs[0]):
        np.testing.assert_array_equal(chunk.semantic, sem)
        np.testing.assert_array_equal(chunk.tokens, tok)


def test_pipelined_speculation_no_frame_leakage(params):
    """Horizon 2 below every budget: rows finish while a speculative
    chunk is in flight and are re-admitted for their next text chunk; a
    stale frame leaking into a chunk would break argmax equality with the
    serial engine."""
    reqs = [([make_prompt(6), make_prompt(4, 1)], 2, 4),
            ([make_prompt(5), make_prompt(6, 2), make_prompt(3, 3)], 3, 3),
            ([make_prompt(7)], 0, 5)]
    expected = [_serial(params, *r) for r in reqs]
    b = ContinuousBatcher(_engine(params, 2), ARGMAX, horizon=2)
    try:
        outs = _run(b, [(p, c, m, {}) for p, c, m in reqs])
    finally:
        b.shutdown()
    for exp, chunks in zip(expected, outs):
        assert len(chunks) == len(exp)
        for (sem, tok), chunk in zip(exp, chunks):
            np.testing.assert_array_equal(chunk.semantic, sem)
            np.testing.assert_array_equal(chunk.tokens, tok)


def test_seeded_request_ignores_cotenants(params):
    """A seeded sampled request gives the same codes alone on a fresh
    batcher and amid other requests, admitted in a burst or alone."""
    mine = ([make_prompt(9)], 0, 9, dict(sampling=SAMPLED, seed=1234))
    codes = []
    for others in ([], [([make_prompt(5, i)], 0, 7, dict(seed=i)) for i in range(3)]):
        b = ContinuousBatcher(_engine(params, 4), SAMPLED, horizon=4)
        try:
            out = _run(b, others + [mine])[-1]
        finally:
            b.shutdown()
        codes.append(np.concatenate([out[0].semantic[None], out[0].tokens]))
    np.testing.assert_array_equal(codes[0], codes[1])


def test_stream_events_match_chunk_results(batcher):
    """stream=True: the partial events of each chunk concatenate to its
    chunk result, which arrives after them."""
    req = batcher.submit([make_prompt(5), make_prompt(6, 1)], cond_len=0, max_new=6,
                         stream=True)
    parts, results = [[]], []
    for ev in req.iter_events(timeout=WAIT):
        if isinstance(ev, _PartialFrames):
            parts[-1].append(ev.frames)
        else:
            assert isinstance(ev, _ChunkResult)
            results.append(ev)
            parts.append([])
    assert len(results) == 2
    for p, chunk in zip(parts, results):
        stacked = np.concatenate(p, axis=1)
        np.testing.assert_array_equal(stacked[1:], chunk.tokens)
        np.testing.assert_array_equal(stacked[0], chunk.semantic)


def test_empty_chunk_has_codebook_rows(params):
    """A chunk that ends with no frame gives tokens (C, 0) and semantic
    (0,). The JAX batcher stacks np.zeros((0, 0)) there, so its tokens
    come out (0, 0) (fish_speech_tpu/generate/continuous.py:870-876)."""
    b = ContinuousBatcher(_engine(params, 1), SAMPLED)
    b.shutdown()
    req = BatchedRequest([make_prompt(4)] * 2, 0, 4)
    slot = _RowState(req, 0)
    slot.chunk_idx, slot.active = 0, True
    b._finish_chunk(slot, hit_max=False)
    chunk = req.results.get(timeout=WAIT)
    assert chunk.tokens.shape == (CFG.num_codebooks, 0) and chunk.semantic.shape == (0,)


def test_shutdown_releases_waiting_clients(params):
    """Shutdown releases in-flight and queued requests alike."""
    b = ContinuousBatcher(_engine(params, 1), SAMPLED, horizon=4)
    reqs = [b.submit([make_prompt(5)] * 4, cond_len=0, max_new=8) for _ in range(3)]
    b.shutdown()
    outcomes = []
    for req in reqs:
        try:
            list(req.iter_chunks(timeout=WAIT))
            outcomes.append("done")
        except RuntimeError:
            outcomes.append("released")
    assert "released" in outcomes


def test_submit_after_shutdown_releases_client(params):
    b = ContinuousBatcher(_engine(params, 1), SAMPLED, horizon=4)
    b.shutdown()
    req = b.submit([make_prompt(4)], cond_len=0, max_new=4)
    with pytest.raises(RuntimeError, match="shut down"):
        list(req.iter_chunks(timeout=WAIT))


def test_scheduler_death_reaches_waiters(params):
    """A decode chunk that raises reaches every waiting client."""
    engine = _engine(params, 2)

    def bad_decode_chunk(*a, **k):
        raise RuntimeError("injected decode failure")

    engine.decode_chunk = bad_decode_chunk
    b = ContinuousBatcher(engine, SAMPLED, horizon=4)
    try:
        reqs = [b.submit([make_prompt(6)], 0, 6), b.submit([make_prompt(5)], 0, 6),
                b.submit([make_prompt(4)], 0, 6)]
        for req in reqs:
            with pytest.raises(RuntimeError, match="injected decode failure"):
                list(req.iter_chunks(timeout=WAIT))
    finally:
        b.shutdown()


@pytest.mark.parametrize("codec", [None, object(), types.SimpleNamespace(can_stream=False)],
                         ids=["no_codec", "no_stream_surface", "cannot_stream"])
def test_central_vocoder_waits_for_the_streaming_codec(params, codec):
    """Central vocoding needs a codec that can stream: without one (none,
    or a codec such as Fish 1.2's whose decode is not causal) it stays
    off, deliver_pcm raises ValueError as the JAX batcher's does
    (continuous.py:586-590), and token requests run as before."""
    engine = _engine(params, 1)
    b = ContinuousBatcher(engine, SAMPLED, codec=codec, shift_fn=lambda c: c)
    try:
        assert b._central is None
        with pytest.raises(ValueError, match="streaming codec"):
            b.submit([make_prompt(4)], 0, 4, deliver_pcm=True)
        b.warmup()
        assert len(list(b.submit([make_prompt(4)], 0, 3).iter_chunks(timeout=WAIT))) == 1
    finally:
        b.shutdown()


def test_iteration_times_out_instead_of_hanging(params):
    b = ContinuousBatcher(_engine(params, 1), SAMPLED)
    b.shutdown()
    req = b.submit([make_prompt(4)], 0, 4)
    req.results.get(timeout=WAIT)  # drop the release sentinel
    with pytest.raises(TimeoutError):
        list(req.iter_chunks(timeout=0.05))
