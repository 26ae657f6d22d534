"""The port's central batched vocoder (generate/continuous.py::
_CentralVocoder), after tests/test_central_vocode.py, at
test_torch_engine.py's tiny LM (2 codebooks) and codec configurations on
the CPU: deliver_pcm requests receive PCM from one B-row carried-state
feed a tick, and each request's concatenated PCM equals the codec's
whole-sequence decode of its own tokens, the port's and the JAX
package's, across staggered admissions, chunk boundaries (a fresh
stream a chunk), ragged drains and row reuse.

PCM crosses to the host as int16 (0.5 / 32767 ~= 1.5e-5 of rounding), so
it is held within 5e-5 absolute of the port's float32 batch decode, and
within 1e-4 of the JAX codec's (XLA sums the convolutions in another
order). Two tests hold the port to behaviour the JAX batcher lacks:
a starved mid-stream lane does not stop another lane's PCM
(continuous.py:336), and a delivery failure does not lose its row
(continuous.py:461-465). Every wait has a timeout."""

import queue
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.models.codec import firefly as jfire
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.generate.continuous import (
    BatchedRequest, ContinuousBatcher, _CentralVocoder, _ChunkResult, _PartialPCM, _RowState)
from fish_speech_tpu_torch.generate.engine import LMEngine
from fish_speech_tpu_torch.io.convert import firefly_params_from_numpy
from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec
from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params
from fish_speech_tpu_torch.ops.sampling import BATCHED_REP_PEN_WINDOW, SamplingArgs
from test_torch_engine import HEAD, KW, QUANT, TOK, VOCAB

torch.set_num_threads(1)
PCM_TOL = 5e-5
JAX_TOL = 1e-4
WAIT = 60.0  # seconds any single wait may take before the test fails
CFG = tcfg.DualARConfig(**{**KW, "vocab_size": VOCAB})


def make_prompt(n, shift=0):
    rng = np.random.default_rng(n + 100 * shift)
    return np.concatenate([rng.integers(10, VOCAB, (1, n)),
                           rng.integers(0, 1000, (2, n))]).astype(np.int32)


@pytest.fixture(scope="module")
def codecs():
    jf = jcfg.FireflyConfig(spec_transform=jcfg.SpecTransformConfig(hop_length=4),
                            head=jcfg.HiFiGANConfig(**HEAD),
                            quantizer=jcfg.DownsampleFSQConfig(**QUANT))
    tf = tcfg.FireflyConfig(spec_transform=tcfg.SpecTransformConfig(hop_length=4),
                            head=tcfg.HiFiGANConfig(**HEAD),
                            quantizer=tcfg.DownsampleFSQConfig(**QUANT))
    shapes = jax.eval_shape(
        lambda: jfire.init_firefly_params(jax.random.PRNGKey(1), jf, jnp.float32))
    leaves, tree = jax.tree.flatten(shapes)
    rng = np.random.default_rng(1)
    params = jax.tree.unflatten(
        tree, [jnp.asarray(rng.normal(size=l.shape).astype(np.float32) * 0.2) for l in leaves])
    return (jfire.FireflyCodec(params, jf, buckets=(8, 16, 32)),
            FireflyCodec(firefly_params_from_numpy(jax.tree.map(np.asarray, params)), tf,
                         device="cpu"))


def _engine(batch):
    params = init_dual_ar_params(CFG, seed=0, dtype=torch.float32, device="cpu")
    return LMEngine(params, CFG, tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5,
                    batch_size=batch, cache_len=64, max_frames=16, prompt_buckets=(16,),
                    dtype=torch.float32, device="cpu", rep_pen_window=BATCHED_REP_PEN_WINDOW,
                    dynamic_sampling=True)


@pytest.fixture(scope="module")
def batcher(codecs):
    b = ContinuousBatcher(_engine(3), SamplingArgs(temp=0.8, top_k=8), horizon=4,
                          codec=codecs[1], shift_fn=lambda c: c)
    yield b
    b.shutdown()


def _collect(req):
    """Per chunk (pcm, tokens, frames delivered as PCM) of a deliver_pcm
    request's events; asserts each chunk's PCM events precede its result."""
    chunks, parts, frames = [], [], 0
    for ev in req.iter_events(timeout=WAIT):
        if isinstance(ev, _PartialPCM):
            assert ev.pcm.dtype == np.float32 and ev.pcm.shape == (ev.frames * 16,)  # spf 16
            parts.append(ev.pcm)
            frames += ev.frames
        else:
            assert isinstance(ev, _ChunkResult)
            pcm = np.concatenate(parts) if parts else np.zeros((0,), np.float32)
            chunks.append((pcm, ev.tokens, frames))
            parts, frames = [], 0
    return chunks


def _run_pcm_request(batcher, prompts, max_new, cond_len=0, seed=None):
    return _collect(batcher.submit(prompts, cond_len=cond_len, max_new=max_new,
                                   deliver_pcm=True, seed=seed))


def _check_chunk(chunk, codecs):
    pcm, tokens, frames = chunk
    jcodec, codec = codecs
    assert frames == tokens.shape[1] >= 1
    np.testing.assert_allclose(pcm, codec.decode(tokens)[0], rtol=0, atol=PCM_TOL)
    np.testing.assert_allclose(pcm, jcodec.decode(tokens)[0], rtol=0, atol=JAX_TOL)


def test_pcm_equals_batch_decode(batcher, codecs):
    batcher.warmup()
    chunks = _run_pcm_request(batcher, [make_prompt(6)], max_new=10, seed=3)
    assert len(chunks) == 1
    _check_chunk(chunks[0], codecs)


def test_pcm_events_precede_final(batcher):
    req = batcher.submit([make_prompt(5)], cond_len=0, max_new=8, deliver_pcm=True, seed=0)
    kinds = [type(ev).__name__ for ev in req.iter_events(timeout=WAIT)]
    assert kinds[-1] == "_ChunkResult" and kinds.count("_ChunkResult") == 1
    assert "_PartialPCM" in kinds


def test_multi_chunk_fresh_stream_per_chunk(batcher, codecs):
    """Each text chunk's PCM is a fresh whole decode of that chunk's
    tokens (the lane is reset at every chunk admission)."""
    chunks = _run_pcm_request(batcher, [make_prompt(8), make_prompt(5, shift=1)], max_new=6,
                              cond_len=3, seed=7)
    assert len(chunks) == 2
    for chunk in chunks:
        _check_chunk(chunk, codecs)


def test_concurrent_staggered_lanes(batcher, codecs):
    """5 requests through 3 rows with different lengths: lane resets on
    row reuse, ragged drains, one lane's stream never touching another's."""
    results = {}

    def worker(i):
        results[i] = _run_pcm_request(batcher, [make_prompt(4 + i % 3)], max_new=5 + i % 4,
                                      seed=i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * WAIT)
    assert not any(t.is_alive() for t in threads)
    assert sorted(results) == list(range(5))
    for i, chunks in results.items():
        assert len(chunks) == 1, i
        _check_chunk(chunks[0], codecs)


def test_mixed_pcm_and_token_delivery(batcher, codecs):
    """deliver_pcm and token-streaming requests together: the vocoder
    touches only the PCM lanes."""
    out = {}

    def pcm_worker():
        out["pcm"] = _run_pcm_request(batcher, [make_prompt(6)], max_new=6, seed=11)

    def tok_worker():
        req = batcher.submit([make_prompt(4)], cond_len=0, max_new=6, stream=True, seed=12)
        out["tok"] = list(req.iter_events(timeout=WAIT))

    threads = [threading.Thread(target=pcm_worker), threading.Thread(target=tok_worker)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * WAIT)
    assert not any(t.is_alive() for t in threads)
    _check_chunk(out["pcm"][0], codecs)
    assert not any(isinstance(ev, _PartialPCM) for ev in out["tok"])
    assert out["tok"][-1].tokens.shape[1] >= 1


def test_deliver_pcm_requires_a_codec():
    b = ContinuousBatcher(_engine(2), SamplingArgs(temp=0.0), horizon=4)
    try:
        with pytest.raises(ValueError, match="deliver_pcm"):
            b.submit([make_prompt(4)], cond_len=0, max_new=4, deliver_pcm=True)
    finally:
        b.shutdown()


def _drained(vocoder, slot):
    """The events the delivery thread has put for slot's request."""
    vocoder.drain(timeout=WAIT)
    events = []
    while True:
        try:
            events.append(slot.req.results.get_nowait())
        except queue.Empty:
            return events


def test_starved_lane_does_not_hold_back_another(codecs):
    """Departure from the JAX batcher, continuous.py:336: its tick takes
    t = min(pending) over every mid-stream lane, so a lane with nothing
    pending stops PCM for all lanes. Here lanes with frames are fed; a
    lane with fewer frames sits the tick out and keeps its state, and
    each lane's PCM still equals the batch decode of its frames."""
    codec = codecs[1]
    fake = types.SimpleNamespace(engine=types.SimpleNamespace(
        batch_size=2, cfg=types.SimpleNamespace(num_codebooks=2)), horizon=8)
    vocoder = _CentralVocoder(fake, codec, None)
    try:
        slots = [_RowState(BatchedRequest([None], 0, 16, deliver_pcm=True), r) for r in (0, 1)]
        for s in slots:
            vocoder.enable_row(s)
        frames = [make_prompt(9, shift=2), make_prompt(5, shift=3)]  # (C+1, T) per lane
        got = [[], []]

        def feed(pushes):
            for r, (a, e) in enumerate(pushes):
                if e > a:
                    vocoder.push(slots[r], frames[r][:, a:e])
            vocoder.tick()
            for r in (0, 1):
                got[r] += _drained(vocoder, slots[r])

        feed([(0, 4), (0, 0)])  # lane 1 is starved: JAX would feed nobody
        assert [ev.frames for ev in got[0]] == [4] and got[1] == []
        feed([(4, 4), (0, 3)])  # now lane 0 sits out and keeps its state
        assert [ev.frames for ev in got[1]] == [3] and len(got[0]) == 1
        feed([(4, 9), (3, 5)])  # both fed 2 frames; lane 0 keeps 3 pending
        assert [ev.frames for ev in got[0]] == [4, 2] and [ev.frames for ev in got[1]] == [3, 2]
        for s in slots:  # both chunks decoded: lane 0 drains its 3, lane 1 ends empty
            s.ending = True
            s.held_final = _ChunkResult(tokens=None, semantic=None, hit_max=False)
        feed([(0, 0), (0, 0)])
        assert [ev.frames for ev in got[0][:-1]] == [4, 2, 3]
        for r in (0, 1):
            assert isinstance(got[r][-1], _ChunkResult)
            pcm = np.concatenate([ev.pcm for ev in got[r][:-1]])
            np.testing.assert_allclose(pcm, codec.decode(frames[r][1:])[0], rtol=0,
                                       atol=PCM_TOL)
        assert {vocoder.released.get(timeout=WAIT).row for _ in range(2)} == {0, 1}
        assert not vocoder.lanes and not vocoder.has_work()
    finally:
        vocoder.shutdown()


class _FailingResults(queue.Queue):
    """A client queue whose PCM events fail to arrive."""

    def put(self, item, *args, **kwargs):
        if isinstance(item, _PartialPCM):
            raise RuntimeError("injected delivery failure")
        super().put(item, *args, **kwargs)


def test_delivery_failure_does_not_lose_the_row(codecs):
    """Departure from the JAX batcher, continuous.py:461-465: when
    delivery raises, it releases the clients but never hands the finished
    rows back, so they are lost to admission for good. Here the row comes
    back: on a one-row batcher a later request is admitted and completes."""
    b = ContinuousBatcher(_engine(1), SamplingArgs(temp=0.8, top_k=8), horizon=4,
                          codec=codecs[1], shift_fn=lambda c: c)
    try:
        req = BatchedRequest([make_prompt(5)], 0, 6, deliver_pcm=True, seed=1)
        req.results = _FailingResults()
        b.queue.put(req)  # as submit does, with the failing queue in place
        b._wake.set()
        with pytest.raises(RuntimeError, match="injected delivery failure"):
            list(req.iter_events(timeout=WAIT))
        chunks = _run_pcm_request(b, [make_prompt(6)], max_new=6, seed=2)
        assert len(chunks) == 1
        _check_chunk(chunks[0], codecs)
    finally:
        b.shutdown()
