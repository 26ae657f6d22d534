"""The port's three CLIs, run in-process with `--device cpu`, against the
JAX package's CLIs on the same checkpoint directory (a tiny LM in the
upstream key names with config.json and tokenizer.json, and the tiny
codec of tests/test_server.py under its upstream file name; the codec
CLIs' per-version config is patched to it in both packages, as
tests/test_cli.py does):

* llama_generate at --temp 0 with a speaker prompt and a text of two
  chunks writes token-exact .npy files. Both CLIs compute in bfloat16,
  and XLA's CPU bf16 arithmetic rounds otherwise than PyTorch's, so an
  argmax can flip; the comparison runs both in float32 (each CLI
  module's bfloat16 patched to float32). The port's bfloat16 run is
  held token-exact to the port's engine driven by hand.
* the vocoder's WAV lies within float32 tolerance (one int16 step);
* the encoder's codes follow the tie rule of tests/test_torch_encode.py;
* without config.json the JAX CLI loads a Fish 1.5 checkpoint with the
  Fish 1.2 config; the port takes the 1.5 config and checks shapes."""

import pytest

# these CPU parity tests (no `cuda` case among them) write their files
# with the safetensors package; where it is missing they are not collected
pytest.importorskip("safetensors")

import dataclasses
import json
import sys
import types

import jax.numpy as jnp
import numpy as np
import torch
from safetensors.numpy import save_file as st_save_numpy

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.audio.wav import read_wav as jax_read_wav
from fish_speech_tpu.cli import encoder as jenc
from fish_speech_tpu.cli import llama_generate as jgen
from fish_speech_tpu.cli import vocoder as jvoc
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.audio.resample import resample
from fish_speech_tpu_torch.audio.wav import read_wav, write_pcm_as_wav
from fish_speech_tpu_torch.cli import encoder as tenc
from fish_speech_tpu_torch.cli import llama_generate as tgen
from fish_speech_tpu_torch.cli import vocoder as tvoc
from fish_speech_tpu_torch.generate.engine import LMEngine
from fish_speech_tpu_torch.io.checkpoint import firefly_state_dict, load_lm_params
from fish_speech_tpu_torch.ops.sampling import SamplingArgs

from test_torch_checkpoint import JCFG, codec_cfgs, jax_codec_params, make_lm_state_dict
from test_torch_encode import _assert_codes, _jax_code_ties

torch.set_num_threads(1)

CODEC_FILE = "firefly-gan-vq-fsq-8x1024-21hz-generator.safetensors"
TEXT = "hello world . the provided text out . speak the text hello world ."


def _write_tokenizer(path, cfg):
    """tests/test_api.py's WordLevel tokenizer: ChatML specials, the
    semantic range right after them, a few words."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<unk>": 0, "<|im_start|>": 1, "<|im_end|>": 4, "<|semantic|>": 5,
             "<|voice|>": 6}
    for i in range(cfg.codebook_size):
        vocab[f"<|semantic:{i}|>"] = 10 + i
    for wid, w in enumerate(["hello", "world", "speak", "out", "the", "provided", "text", "."],
                            start=30):
        vocab[w] = wid
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(path))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The checkpoint directory: LM weights (the im_end head row zeroed,
    so generations run their length), config.json, tokenizer.json, a
    speaker's codes and the codec's weights."""
    d = tmp_path_factory.mktemp("ckpt")
    sd = make_lm_state_dict(JCFG, np.random.default_rng(0))
    sd["output.weight"][4] = 0.0
    st_save_numpy(sd, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(dataclasses.asdict(JCFG)))
    _write_tokenizer(d / "tokenizer.json", JCFG)
    np.save(d / "voice.npy", np.random.default_rng(3).integers(
        0, JCFG.codebook_size, size=(JCFG.num_codebooks, 5)).astype(np.uint32))
    jc, tc = codec_cfgs("1.5")
    params = jax_codec_params(jc, seed=7, scale=0.1)  # PCM peaks near 0.13, below clipping
    st_save_numpy({k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in
                   firefly_state_dict(params, tc).items()}, str(d / CODEC_FILE))
    return d


@pytest.fixture
def tiny_codec_config(monkeypatch):
    jc, tc = codec_cfgs("1.5")
    monkeypatch.setattr(jcfg.FireflyConfig, "for_version", staticmethod(lambda v: jc))
    monkeypatch.setattr(tcfg.FireflyConfig, "for_version", staticmethod(lambda v: tc))
    return jc, tc


def _run_jax(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + [str(a) for a in argv])
    module.main()


def _gen_argv(ckpt, version, out, *extra):
    return ["--checkpoint", ckpt, "--fish-version", version, "--text", TEXT,
            "--prompt-tokens", ckpt / "voice.npy", "--prompt-text", "hello",
            "--max-new-tokens", "6", "--temp", "0", "--seed", "0", "--out-path", out, *extra]


@pytest.mark.parametrize("version", ["1.5", "dual_ar", "1.2"])
def test_llama_generate_token_exact(ckpt, tmp_path, monkeypatch, version):
    """Two chunks, a speaker prompt, temp 0, float32: equal .npy files
    (uint32, the 1.2 codes shifted by -1)."""
    monkeypatch.setattr(jgen, "jnp", types.SimpleNamespace(bfloat16=jnp.float32))
    monkeypatch.setattr(tgen, "torch", types.SimpleNamespace(bfloat16=torch.float32))
    _run_jax(jgen, _gen_argv(ckpt, version, tmp_path / "j.npy"), monkeypatch)
    tgen.main([str(a) for a in _gen_argv(ckpt, version, tmp_path / "t.npy", "--device",
                                         "cpu")])
    ref, got = np.load(tmp_path / "j.npy"), np.load(tmp_path / "t.npy")
    assert got.dtype == ref.dtype == np.uint32
    assert got.shape[0] == JCFG.num_codebooks and got.shape[1] > 6  # both chunks ran
    np.testing.assert_array_equal(got, ref)


def test_llama_generate_bf16_equals_engine(ckpt, tmp_path):
    """The default bfloat16 CLI run equals the port's engine driven by hand
    on the same prompts: chunk 1 with the conditioning, rewind to it,
    chunk 2 at that offset, one seed. The first chunk's prompt holds the
    speaker's codes verbatim in the codebook rows and <|semantic:0|> +
    row 0 in the semantic row."""
    out = tmp_path / "t.npy"
    argv = [str(a) for a in _gen_argv(ckpt, "1.5", out, "--device", "cpu")]
    argv[argv.index("--temp") + 1] = "0.7"
    tgen.main(argv)
    args = tgen.build_parser().parse_args(argv)
    tok = tgen.load_tokenizer(ckpt / "tokenizer.json")
    cfg = tcfg.DualARConfig.from_json(ckpt / "config.json")
    lm = tcfg.WhichLM.FISH_1_5
    n_cond, prompts = tgen.build_prompts(tok, cfg, lm, args)
    assert len(prompts) == 2 and prompts[0].shape[1] > n_cond > 0
    voice = np.load(ckpt / "voice.npy").astype(np.int32)
    first = prompts[0]
    starts = [i for i in range(first.shape[1] - voice.shape[1] + 1)
              if np.array_equal(first[1:, i:i + voice.shape[1]], voice)]
    assert len(starts) == 1
    s = starts[0]
    np.testing.assert_array_equal(first[0, s:s + voice.shape[1]],
                                  tok.token_to_id("<|semantic:0|>") + voice[0])

    params = load_lm_params(ckpt, cfg, device="cpu")
    engine = LMEngine(params, cfg, tcfg.TokenConfig.from_tokenizer(lm, tok, cfg), lm,
                      device="cpu")
    sampling = SamplingArgs(temp=0.7, top_p=0.7, top_k=256, repetition_penalty=1.2)
    state = engine.init_state(0)
    r1, state = engine.generate(prompts[0], max_new_tokens=6, sampling=sampling, state=state)
    state = engine.rewind(state, n_cond)
    r2, _ = engine.generate(prompts[1], max_new_tokens=6, sampling=sampling, state=state,
                            conditioning_offset=n_cond)
    np.testing.assert_array_equal(np.load(out), np.concatenate([r1.tokens, r2.tokens], 1))


def test_vocoder_wav_within_float32(ckpt, tmp_path, monkeypatch, tiny_codec_config):
    codes = np.random.default_rng(0).integers(0, 1000, size=(2, 10)).astype(np.uint32)
    np.save(tmp_path / "codes.npy", codes[None])
    common = ["--input", tmp_path / "codes.npy", "--checkpoint", ckpt]
    _run_jax(jvoc, common + ["--out-path", tmp_path / "j.wav"], monkeypatch)
    tvoc.main([str(a) for a in common + ["--out-path", tmp_path / "t.wav", "--device", "cpu"]])
    ref, sr = jax_read_wav(str(tmp_path / "j.wav"))
    got, sr_t = read_wav(str(tmp_path / "t.wav"))
    jc, _ = tiny_codec_config
    assert sr_t == sr == jc.spec_transform.sample_rate
    assert got.shape == ref.shape == (10 * jc.samples_per_frame,)
    assert float(np.abs(got - ref).max()) <= 1.0 / 32768 + 1e-7  # one int16 step
    tvoc.main([str(a) for a in common + ["--out-path", tmp_path / "b.wav", "--device", "cpu",
                                         "--bf16"]])
    bf, _ = read_wav(str(tmp_path / "b.wav"))
    assert bf.shape == ref.shape and np.isfinite(bf).all()


@pytest.mark.parametrize("rate", [44100, 24000])
def test_encoder_codes(ckpt, tmp_path, monkeypatch, tiny_codec_config, rate):
    """A 16-bit WAV at 44.1 or 24 kHz: both CLIs' codes, held by the tie
    rule against the JAX arithmetic on the resampled audio."""
    jc, tc = tiny_codec_config
    pcm = (np.random.default_rng(rate).normal(size=rate // 4) * 0.2).astype(np.float32)
    with open(tmp_path / "ref.wav", "wb") as f:
        write_pcm_as_wav(f, pcm, rate)
    common = ["--input", tmp_path / "ref.wav", "--checkpoint", ckpt]
    _run_jax(jenc, common + ["--out-path", tmp_path / "j.npy"], monkeypatch)
    tenc.main([str(a) for a in common + ["--out-path", tmp_path / "t.npy", "--device", "cpu"]])
    ref, got = np.load(tmp_path / "j.npy"), np.load(tmp_path / "t.npy")
    assert got.dtype == ref.dtype == np.uint32
    audio, sr = read_wav(str(tmp_path / "ref.wav"))
    audio = resample(audio, sr, jc.spec_transform.sample_rate)
    from fish_speech_tpu.audio.mel import LogMelSpectrogram
    from fish_speech_tpu.io.checkpoint import load_firefly_params

    mel = np.asarray(LogMelSpectrogram(jc.spec_transform)(audio))
    ties = _jax_code_ties(jc, load_firefly_params(ckpt, jc), mel)[0]
    _assert_codes(got, ref, ties, f"encoder CLI at {rate} Hz")


def test_missing_config_json_divergence(ckpt, tmp_path, monkeypatch):
    """Without config.json the JAX CLI falls back to the Fish 1.2 config
    for every --fish-version: a 1.5 checkpoint would load with 4
    codebooks and a 32000 vocab, unchecked. The port takes the version's
    config (8 codebooks, vocab 102048 for 1.5) and its loader refuses a
    checkpoint of other shapes, naming the tensor."""
    bare = tmp_path / "bare"
    bare.mkdir()
    for name in ("model.safetensors", "tokenizer.json", "voice.npy"):
        (bare / name).write_bytes((ckpt / name).read_bytes())
    seen = {}

    def capture(path, cfg, dtype):
        seen["cfg"] = cfg
        raise RuntimeError("captured")

    monkeypatch.setattr(jgen, "load_lm_params", capture)
    with pytest.raises(RuntimeError, match="captured"):
        _run_jax(jgen, _gen_argv(bare, "1.5", tmp_path / "j.npy"), monkeypatch)
    assert (seen["cfg"].num_codebooks, seen["cfg"].vocab_size) == (4, 32000)

    cfg = tgen.load_config(bare, tcfg.WhichModel.FISH_1_5)
    assert cfg == tcfg.DualARConfig.fish_speech_1_5()
    assert tgen.load_config(bare, tcfg.WhichModel.FISH_1_2) == tcfg.DualARConfig.fish_speech_1_2()
    with pytest.raises(FileNotFoundError, match="config.json"):
        tgen.load_config(bare, tcfg.WhichModel.FISH_1_4)
    with pytest.raises(ValueError, match=r"'embeddings\.weight' has shape \(64, 32\)"):
        tgen.main([str(a) for a in _gen_argv(bare, "1.5", tmp_path / "t.npy", "--device",
                                             "cpu")])


@pytest.mark.parametrize("cli", ["llama_generate", "vocoder", "encoder"])
def test_cli_repo_id_does_not_fetch(cli, tmp_path):
    """Each CLI resolves --checkpoint through io/hub.py: a repo id raises
    before anything is read, naming the pinned repo."""
    mains = {"llama_generate": (tgen.main, ["--text", "hi"]), "vocoder": (tvoc.main, []),
             "encoder": (tenc.main, ["--input", str(tmp_path / "x.wav")])}
    main, extra = mains[cli]
    with pytest.raises(ValueError, match="does not fetch.*jkeisling/fish-speech-1.5"):
        main(["--checkpoint", "someone/some-repo", "--device", "cpu"] + extra)


def test_codec_clis_take_a_weights_file(ckpt, tmp_path, tiny_codec_config):
    """The vocoder and the encoder also take the codec's weights file
    itself, as the JAX CLIs do: the same codes as from the directory."""
    with open(tmp_path / "ref.wav", "wb") as f:
        write_pcm_as_wav(f, (np.random.default_rng(1).normal(size=4096) * 0.2).astype(
            np.float32), 44100)
    for i, where in enumerate([ckpt, ckpt / CODEC_FILE]):
        tenc.main(["--input", str(tmp_path / "ref.wav"), "--checkpoint", str(where),
                   "--device", "cpu", "--out-path", str(tmp_path / f"{i}.npy")])
    np.testing.assert_array_equal(np.load(tmp_path / "0.npy"), np.load(tmp_path / "1.npy"))
    tvoc.main(["--input", str(tmp_path / "1.npy"), "--checkpoint", str(ckpt / CODEC_FILE),
               "--device", "cpu", "--out-path", str(tmp_path / "out.wav")])
    assert read_wav(str(tmp_path / "out.wav"))[0].shape[0] > 0
