"""The port's Python API (fish_speech_tpu_torch/api.py: `LM`,
`FireflyCodec`) against the JAX package's, after tests/test_api.py: a
synthetic checkpoint directory (tiny LM in the upstream key names,
config.json, tokenizer.json, its <|im_end|> head row strengthened so that
argmax generations end, and the tiny Firefly-1.5 codec), both APIs in
float32 on the CPU. Codes are held token-exact (uint32, raw model
output); decoded PCM within 1e-4 absolute (float32); encoded codes by
test_torch_encode.py's tie rule."""

import pytest

pytest.importorskip("safetensors")
pytest.importorskip("tokenizers")

import dataclasses
import json

import numpy as np
import torch
from safetensors.numpy import save_file

from fish_speech_tpu import api as japi
from fish_speech_tpu import config as jcfg
from fish_speech_tpu_torch import api as tapi
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.io.checkpoint import firefly_state_dict
from test_torch_checkpoint import JCFG, codec_cfgs, jax_codec_params, make_lm_state_dict
from test_torch_cli import CODEC_FILE, _write_tokenizer
from test_torch_encode import MAX_FLIP_SHARE

torch.set_num_threads(1)
TOL = 1e-4


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("api_ckpt")
    sd = make_lm_state_dict(JCFG, np.random.default_rng(0))
    sd["output.weight"][4] *= 50.0  # argmax generations reach <|im_end|>
    save_file(sd, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(dataclasses.asdict(JCFG)))
    _write_tokenizer(d / "tokenizer.json", JCFG)
    jc, tc = codec_cfgs("1.5")
    params = jax_codec_params(jc, seed=7, scale=0.1)
    save_file({k: np.ascontiguousarray(np.asarray(v, np.float32))
               for k, v in firefly_state_dict(params, tc).items()}, str(d / CODEC_FILE))
    return d


@pytest.fixture(scope="module")
def lms(checkpoint_dir):
    return (japi.LM(str(checkpoint_dir), version="1.5", device="cpu", dtype="f32"),
            tapi.LM(str(checkpoint_dir), version="1.5", device="cpu", dtype="f32"))


@pytest.fixture
def codecs(checkpoint_dir, monkeypatch):
    jc, tc = codec_cfgs("1.5")
    monkeypatch.setattr(jcfg.FireflyConfig, "for_version", staticmethod(lambda v: jc))
    monkeypatch.setattr(tcfg.FireflyConfig, "for_version", staticmethod(lambda v: tc))
    return (japi.FireflyCodec(checkpoint_dir, version="1.5", device="cpu"),
            tapi.FireflyCodec(checkpoint_dir, version="1.5", device="cpu"))


@pytest.mark.parametrize("chunks", [["hello world ."], ["hello world .", "speak the text ."]])
def test_lm_codes_equal(lms, chunks):
    jlm, tlm = lms
    got = tlm(chunks, temp=0.0, max_new_tokens=8)
    ref = jlm(chunks, temp=0.0, max_new_tokens=8)
    assert got.dtype == ref.dtype == np.uint32 and got.shape[:2] == (1, JCFG.num_codebooks)
    assert got.max() < JCFG.codebook_size
    np.testing.assert_array_equal(got, ref)


def test_lm_speaker_prompt_equal(lms):
    jlm, tlm = lms
    codes = np.random.default_rng(1).integers(0, JCFG.codebook_size,
                                              size=(JCFG.num_codebooks, 4), dtype=np.uint32)
    sample = [{"text": "hello", "codes": codes[None]}, {"text": "world", "codes": codes}]
    spk = tlm.create_speaker_prompt(sample)
    np.testing.assert_array_equal(spk, jlm.create_speaker_prompt(sample))
    assert spk.shape[:2] == (1, JCFG.num_codebooks + 1) and spk.dtype == np.uint32
    spk = tlm.create_speaker_prompt(sample[:1])  # one sample fits the 64-slot cache
    got = tlm(["world ."], speaker_prompt=spk, temp=0.0, max_new_tokens=6)
    np.testing.assert_array_equal(got, jlm(["world ."], speaker_prompt=spk, temp=0.0,
                                           max_new_tokens=6))
    with pytest.raises(ValueError, match="empty"):
        tlm.create_speaker_prompt([])


def test_codec_decode_and_encode(codecs):
    jcodec, tcodec = codecs
    assert tcodec.sample_rate == jcodec.sample_rate == 44100
    codes = np.random.default_rng(2).integers(0, 1000, size=(2, 2, 9)).astype(np.uint32)
    pcm = tcodec.decode(codes)
    assert pcm.shape == (2, 1, 9 * 128) and pcm.dtype == np.float32
    np.testing.assert_allclose(pcm, jcodec.decode(codes), rtol=0, atol=TOL)
    np.testing.assert_allclose(tcodec.decode(codes[0]), pcm[:1], rtol=0, atol=1e-6)
    audio = (np.random.default_rng(3).normal(size=(1, 1, 5000)) * 0.2).astype(np.float32)
    got, ref = tcodec.encode(audio), jcodec.encode(audio)
    assert got.dtype == ref.dtype == np.uint32 and got.shape == ref.shape
    assert np.count_nonzero(got != ref) <= MAX_FLIP_SHARE * got.size
    with pytest.raises(ValueError, match="Firefly"):
        tapi.FireflyCodec(".", version="dual_ar", device="cpu")
