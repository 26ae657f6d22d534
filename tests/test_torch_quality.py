"""The port's int8 decision machinery against the JAX package on the same
numpy-seeded inputs: the teacher-forced forwards (`train/loss.py`,
float32, 1e-4 absolute: three layers summed in another order), their
argmax predictions and agreement (exactly equal), the log-mel front end
(`audio/mel.py`: the filterbank bit-equal, the spectrogram within 1e-4
absolute in log space, float32 FFTs of two libraries), the PCM and mel
metrics, and the int8 policy on a temporary decision file and under
FISH_TPU_INT8."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.audio import mel as jmel
from fish_speech_tpu.models.dual_ar import init_dual_ar_params
from fish_speech_tpu.ops import quant as jq
from fish_speech_tpu.train import loss as jloss
from fish_speech_tpu.utils import int8_policy as jpolicy
from fish_speech_tpu.utils import quality as jquality
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.audio import mel as tmel
from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy
from fish_speech_tpu_torch.train import loss as tloss
from fish_speech_tpu_torch.utils import int8_policy as tpolicy
from fish_speech_tpu_torch.utils import quality as tquality

torch.set_num_threads(1)

KW = dict(vocab_size=300, n_layer=3, n_fast_layer=2, n_head=4, dim=64, intermediate_size=128,
          n_local_heads=2, head_dim=16, rope_base=10000.0, norm_eps=1e-6, max_seq_len=64,
          codebook_size=128, num_codebooks=4)
TOK = dict(im_end_id=9, pad_id=5, semantic_start_id=10, semantic_end_id=137)
TOL = 1e-4


@pytest.fixture(scope="module", params=["dense", "int8", "depthwise"])
def lm(request):
    depthwise = request.param == "depthwise"
    jc = jcfg.DualARConfig(**KW, depthwise_wte=depthwise, depthwise_output=depthwise)
    params = jax.jit(init_dual_ar_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(1), jc, jnp.float32)
    if request.param == "int8":
        params = jq.quantize_lm_params(params)
    tc = tcfg.DualARConfig(**KW, depthwise_wte=depthwise, depthwise_output=depthwise)
    return jc, tc, params, dual_ar_params_from_numpy(jax.tree.map(np.asarray, params))


def _sequence(seed, n_text=6, n_audio=14):
    """(C+1, S): text frames (codebooks 0), then audio frames."""
    rng = np.random.default_rng(seed)
    text = np.concatenate([rng.integers(200, 300, (1, n_text)), np.zeros((4, n_text))])
    audio = np.concatenate([rng.integers(10, 138, (1, n_audio)),
                            rng.integers(0, 128, (4, n_audio))])
    return np.concatenate([text, audio], axis=1).astype(np.int32)


def test_forwards_match_jax(lm):
    jc, tc, jp, tp = lm
    tokens = np.stack([_sequence(0), _sequence(1)])
    lens = np.array([20, 15], np.int32)
    ref = np.asarray(jloss.slow_forward_full(jp, jc, jcfg.TokenConfig(**TOK),
                                             jnp.asarray(tokens), jnp.asarray(lens), remat=False))
    got = tloss.slow_forward_full(tp, tc, tcfg.TokenConfig(**TOK), torch.from_numpy(tokens),
                                  torch.from_numpy(lens))
    for b, n in enumerate(lens):  # positions past a row's length are don't-care
        np.testing.assert_allclose(got[b, :n].numpy(), ref[b, :n], atol=TOL, rtol=0)
    rng = np.random.default_rng(2)
    hidden = rng.normal(size=(5, jc.dim)).astype(np.float32)
    cbs = rng.integers(0, 128, (5, 4)).astype(np.int32)
    ref = np.asarray(jloss.fast_forward_teacher(jp, jc, jnp.asarray(hidden), jnp.asarray(cbs)))
    got = tloss.fast_forward_teacher(tp, tc, torch.from_numpy(hidden), torch.from_numpy(cbs))
    assert got.shape == ref.shape == (5, 4, KW["codebook_size"])
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)


def test_teacher_forced_predictions_match_jax(lm):
    jc, tc, jp, tp = lm
    seq = _sequence(3)
    ref = jquality.teacher_forced_predictions(jp, jc, jcfg.TokenConfig(**TOK), seq)
    got = tquality.teacher_forced_predictions(tp, tc, tcfg.TokenConfig(**TOK), seq)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
    assert got[2][:5].sum() == 0 and got[2][5:].all()  # text targets, then audio


def test_teacher_forced_agreement_matches_jax():
    rng = np.random.default_rng(4)
    mask = rng.random(30) < 0.6
    a = (rng.integers(0, 5, 30), rng.integers(0, 5, (30, 4)), mask)
    b = (rng.integers(0, 5, 30), rng.integers(0, 5, (30, 4)), mask)
    for x, y in ((a, b), (a, a)):
        assert tquality.teacher_forced_agreement(x, y) == jquality.teacher_forced_agreement(x, y)
    assert tquality.teacher_forced_agreement(a, a)["combined"] == 1.0


def test_pcm_metrics_match_jax():
    rng = np.random.default_rng(5)
    a = rng.normal(size=1000).astype(np.float32)
    b = a[:990] + 0.01 * rng.normal(size=990).astype(np.float32)  # cut to the common length
    for x, y in ((a, b), (a, a)):
        assert tquality.pcm_metrics(x, y) == jquality.pcm_metrics(x, y)


SPEC = dict(sample_rate=8000, n_mels=40, n_fft=256, hop_length=64)


@pytest.mark.parametrize("n", [2000, 100, 3])
def test_log_mel_matches_jax(n):
    np.testing.assert_array_equal(tmel.mel_filterbank(44100, 2048, 160),
                                  jmel.mel_filterbank(44100, 2048, 160))
    assert tmel.num_frames(n, 256, 64) == jmel.num_frames(n, 256, 64)
    rng = np.random.default_rng(n)
    audio = (0.3 * np.sin(np.arange(n) * 0.05) + 0.05 * rng.normal(size=n)).astype(np.float32)
    ref = np.asarray(jmel.LogMelSpectrogram(jcfg.SpecTransformConfig(**SPEC))(audio))
    got = tmel.LogMelSpectrogram(tcfg.SpecTransformConfig(**SPEC), device="cpu")(audio)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)


def test_mel_l1_distance_matches_jax():
    rng = np.random.default_rng(6)
    a = (0.2 * rng.normal(size=4000)).astype(np.float32)
    b = a + (0.02 * rng.normal(size=4000)).astype(np.float32)
    for x, y in ((a, b), (a, a), (a, b[:3500])):
        got = tquality.mel_l1_distance(x, y, tcfg.SpecTransformConfig(**SPEC), device="cpu")
        ref = jquality.mel_l1_distance(x, y, jcfg.SpecTransformConfig(**SPEC))
        assert abs(got - ref) <= TOL
    assert tquality.mel_l1_distance(a, a, tcfg.SpecTransformConfig(**SPEC), device="cpu") == 0.0


def test_int8_policy_constants_and_verdict_match_jax():
    assert tpolicy.criteria_dict() == jpolicy.criteria_dict()
    for args in ((0.995, 0.01, 0.005, 20.0), (0.98, 0.01, 0.005, 20.0),
                 (0.995, 0.02, 0.005, 20.0), (0.995, 0.01, 0.005, 15.0), (0.99, 0.0, 0.0, 16.0)):
        assert tpolicy.evaluate(*args) == jpolicy.evaluate(*args)
    assert tpolicy.DECISION_FILE.parent.name == "fish_speech_tpu_torch"


def test_int8_policy_decision_file(tmp_path, monkeypatch):
    """A missing file means bf16; runs on random weights add evidence
    only; a passing real-weight run flips the default and a failing one
    flips it back; FISH_TPU_INT8 overrides the file."""
    monkeypatch.delenv("FISH_TPU_INT8", raising=False)
    path = tmp_path / "int8_decision.json"
    assert tpolicy.read_decision(path) is None and not tpolicy.serving_default_int8(path)
    metrics = {"token_agreement": 0.995, "mel_l1": 0.01}
    tpolicy.record_decision(metrics, True, real_weights=False, evidence="random", path=path)
    assert not tpolicy.serving_default_int8(path)
    ref_path = tmp_path / "jax_decision.json"
    jpolicy.record_decision(metrics, True, real_weights=False, evidence="random", path=ref_path)
    # the same record as the JAX package's, with the port's criteria version
    mine = json.loads(path.read_text())
    assert mine.pop("criteria_version") == tpolicy.CRITERIA_VERSION
    assert [r.pop("criteria_version") for r in mine["runs"]] == [tpolicy.CRITERIA_VERSION]
    assert mine == json.loads(ref_path.read_text())
    tpolicy.record_decision(metrics, True, real_weights=True, evidence="real", path=path)
    assert tpolicy.serving_default_int8(path)
    for env, want in (("0", False), ("false", False), ("1", True), ("", True)):
        monkeypatch.setenv("FISH_TPU_INT8", env)
        assert tpolicy.serving_default_int8(path) == want
    monkeypatch.setenv("FISH_TPU_INT8", "1")
    assert tpolicy.serving_default_int8(tmp_path / "missing.json")
    monkeypatch.delenv("FISH_TPU_INT8")
    tpolicy.record_decision(metrics, False, real_weights=True, evidence="real", path=path)
    assert not tpolicy.serving_default_int8(path)
    for _ in range(9):
        tpolicy.record_decision(metrics, False, real_weights=False, evidence="x", path=path)
    assert len(tpolicy.read_decision(path)["runs"]) == 8


@pytest.mark.parametrize("version", [None, 0, "next"])
def test_int8_policy_ignores_other_criteria_versions(tmp_path, monkeypatch, version):
    """A record whose default was set under other criteria, or before the
    record had a version, reads as bf16; the next run keeps the old runs
    as history, starts the default afresh at bf16 and writes the current
    version into the record and the run; a real-weight pass then flips it."""
    monkeypatch.delenv("FISH_TPU_INT8", raising=False)
    path = tmp_path / "int8_decision.json"
    old_run = {"metrics": {"token_agreement": 0.999}, "passed": True, "real_weights": True,
               "evidence": "older criteria"}
    record = {"default": "int8", "decided_on_real_weights": True, "runs": [old_run],
              "criteria": tpolicy.criteria_dict()}
    if version is not None:
        record["criteria_version"] = tpolicy.CRITERIA_VERSION + 1 if version == "next" else version
    path.write_text(json.dumps(record))
    assert not tpolicy.serving_default_int8(path)
    metrics = {"token_agreement": 0.995, "mel_l1": 0.01}
    got = tpolicy.record_decision(metrics, True, real_weights=False, evidence="random", path=path)
    assert got["default"] == "bf16" and "decided_on_real_weights" not in got
    assert got["criteria_version"] == tpolicy.CRITERIA_VERSION
    assert got["runs"][0] == old_run
    assert got["runs"][1]["criteria_version"] == tpolicy.CRITERIA_VERSION
    assert not tpolicy.serving_default_int8(path)
    tpolicy.record_decision(metrics, True, real_weights=True, evidence="real", path=path)
    assert tpolicy.serving_default_int8(path)
