"""The port's text front end and config helpers against the JAX
package's: cleaning, script detection and chunking equal on the same
strings; every PromptEncoder method token-exact for Fish 1.2 / 1.4 /
1.5 / DualAR on the in-memory WordLevel tokenizer of tests/test_text.py;
TokenConfig.from_tokenizer, DualARConfig.from_json and the version
enums equal."""

import dataclasses
import json

import numpy as np
import pytest

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.pipeline import FISH_1_5_SYSPROMPT as JAX_SYSPROMPT
from fish_speech_tpu.text import clean as jclean
from fish_speech_tpu.text import prompt as jprompt
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.text import clean as tclean
from fish_speech_tpu_torch.text import prompt as tprompt

TEXTS = [
    "Hello world.",
    "  “Quoted” text… with — dashes -- and  spaces ,, and.... dots  ",
    "Emoji 😀 stripped 🎉 here! Really? Yes.",
    "这是一个中文句子。这是第二个句子！还有第三个？",
    "日本語の文章です。これは二番目の文です。",
    "한국어 문장입니다. 두 번째 문장입니다.",
    "Short one. " + "This is a much longer second sentence. " * 8,
    ("word " * 100).strip() + ", " + ("word " * 100).strip() + ". And a tail",
    "A「quote」and『another』in（brackets）【here】：colon；semi、comma",
    "",
    "   ",
]


@pytest.mark.parametrize("text", TEXTS)
def test_clean_detect_and_chunk_equal(text):
    assert tclean.clean_text(text) == jclean.clean_text(text)
    assert tclean.detect_script(text).value == jclean.detect_script(text).value
    assert tclean.preprocess_text(text) == jclean.preprocess_text(text)


def _vocab():
    vocab = {"<unk>": 0, "<|im_start|>": 1, "<|im_end|>": 4, "<|semantic|>": 5, "user": 20,
             "assistant": 21, "system": 22, "Hello": 23, "world": 24, "<|voice|>": 99,
             "Speak": 30, "out": 31, "the": 32, "provided": 33, "text": 34, ".": 35}
    for i in range(8):
        vocab[f"<|semantic:{i}|>"] = 100 + i
    return vocab


def _tokenizer(vocab=None):
    """tests/test_text.py's in-memory WordLevel tokenizer (no file)."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = vocab or _vocab()
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens([t for t in vocab if t.startswith("<|")])
    return tok


LMS = ["FISH_1_2", "FISH_1_4", "FISH_1_5", "DUAL_AR"]
NUM_CODEBOOKS = 2


def _encoders(lm, tok=None):
    tok = tok or _tokenizer()
    return (jprompt.PromptEncoder(tok, NUM_CODEBOOKS, jcfg.WhichLM[lm]),
            tprompt.PromptEncoder(tok, NUM_CODEBOOKS, tcfg.WhichLM[lm]))


def _equal(a, b):
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)


CODES = np.asarray([[0, 3, 7, 1], [1, 1, 2, 6]])


@pytest.mark.parametrize("lm", LMS)
def test_prompt_encoder_turns_equal(lm):
    j, t = _encoders(lm)
    for role, content in (("user", "Hello world"), ("system", None), ("assistant", "")):
        _equal(t.encode_text(role, content), j.encode_text(role, content))
    _equal(t.encode_vq(None), j.encode_vq(None))
    _equal(t.encode_vq(CODES), j.encode_vq(CODES))
    _equal(t.encode_conditioning_prompt("Hello", CODES),
           j.encode_conditioning_prompt("Hello", CODES))
    with pytest.raises(ValueError, match="codebooks"):
        t.encode_vq(CODES[:1])


@pytest.mark.parametrize("lm", LMS)
def test_prompt_encoder_quirks(lm):
    """1.5 / DualAR: <|semantic:N|> ids in the semantic row, the codes as
    they are; 1.5 alone adds <|voice|>; <= 1.4: <|semantic|> (pad) in the
    semantic row and the codes + 1."""
    _, t = _encoders(lm)
    out = t.encode_vq(CODES)
    prefix = 3 if lm == "FISH_1_5" else 2
    span = out[:, prefix:prefix + CODES.shape[1]]
    if lm in ("FISH_1_5", "DUAL_AR"):
        np.testing.assert_array_equal(span[0], 100 + CODES[0])
        np.testing.assert_array_equal(span[1:], CODES)
    else:
        np.testing.assert_array_equal(span[0], 5)
        np.testing.assert_array_equal(span[1:], CODES + 1)
    assert (99 in out[0]) == (lm == "FISH_1_5")


@pytest.mark.parametrize("lm", LMS)
@pytest.mark.parametrize("sysprompt", [None, "Speak out the provided text ."])
@pytest.mark.parametrize("speaker", [False, True])
@pytest.mark.parametrize("assume_kv_cache", [False, True])
def test_encode_sequence_equal(lm, sysprompt, speaker, assume_kv_cache):
    j, t = _encoders(lm)
    chunks = ["Hello world .", "the provided text .", "world"]
    spk_j = j.encode_conditioning_prompt("Hello", CODES) if speaker else None
    spk_t = t.encode_conditioning_prompt("Hello", CODES) if speaker else None
    nj, ej = j.encode_sequence(chunks, sysprompt, spk_j, assume_kv_cache)
    nt, et = t.encode_sequence(chunks, sysprompt, spk_t, assume_kv_cache)
    assert nt == nj and len(et) == len(ej) == 3
    for a, b in zip(et, ej):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="empty"):
        t.encode_sequence([], sysprompt, spk_t, assume_kv_cache)


def test_sysprompt_equal():
    assert tprompt.FISH_1_5_SYSPROMPT == JAX_SYSPROMPT


@pytest.mark.parametrize("shape", [(2, 5), (1, 2, 5), (3, 5), (5,)])
def test_load_prompt_tokens_equal(tmp_path, shape):
    arr = np.arange(int(np.prod(shape)), dtype=np.uint32).reshape(shape) % 8
    path = tmp_path / "voice.npy"
    np.save(path, arr)
    try:
        ref = jprompt.load_prompt_tokens(path, NUM_CODEBOOKS)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tprompt.load_prompt_tokens(path, NUM_CODEBOOKS)
        assert str(got.value) == str(e)
        return
    _equal(tprompt.load_prompt_tokens(path, NUM_CODEBOOKS), ref)


CFG_KW = dict(vocab_size=64, n_layer=2, n_fast_layer=2, n_head=4, dim=32,
              intermediate_size=64, n_local_heads=2, head_dim=8, rope_base=10000.0,
              norm_eps=1e-6, max_seq_len=64, codebook_size=8, num_codebooks=2)


@pytest.mark.parametrize("lm", LMS)
@pytest.mark.parametrize("drop", [None, "<|semantic:0|>", "<|semantic|>", "<|semantic:7|>"])
def test_token_config_from_tokenizer_equal(lm, drop):
    """Equal with every token present, and with one missing (the
    fallback ids 100012 and 5, or no semantic end)."""
    vocab = {k: v for k, v in _vocab().items() if k != drop}
    tok = _tokenizer(vocab)
    j = jcfg.TokenConfig.from_tokenizer(jcfg.WhichLM[lm], tok, jcfg.DualARConfig(**CFG_KW))
    t = tcfg.TokenConfig.from_tokenizer(tcfg.WhichLM[lm], tok, tcfg.DualARConfig(**CFG_KW))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_token_config_needs_im_end():
    vocab = {k: v for k, v in _vocab().items() if k != "<|im_end|>"}
    with pytest.raises(ValueError, match="im_end"):
        tcfg.TokenConfig.from_tokenizer(tcfg.WhichLM.FISH_1_5, _tokenizer(vocab),
                                        tcfg.DualARConfig(**CFG_KW))


@pytest.mark.parametrize("extra", [{}, {"depthwise_wte": None, "depthwise_output": None},
                                   {"depthwise_wte": True, "tie_word_embeddings": True,
                                    "model_type": "dual_ar", "unknown_key": 3,
                                    "dropout": 0.1}])
def test_dual_ar_config_from_json_equal(tmp_path, extra):
    path = tmp_path / "config.json"
    path.write_text(json.dumps({**CFG_KW, **extra}))
    j = jcfg.DualARConfig.from_json(path)
    t = tcfg.DualARConfig.from_json(path)
    # every field of the port's; the JAX config also keeps fields that
    # nothing reads (dropout, model_type, use_gradient_checkpointing)
    assert dataclasses.asdict(t) == {k: v for k, v in dataclasses.asdict(j).items()
                                     if k in dataclasses.asdict(t)}
    assert (t.fast_vocab_size, t.fast_output_size, t.ffn_dim) == (
        j.fast_vocab_size, j.fast_output_size, j.ffn_dim)


@pytest.mark.parametrize("name", ["FISH_1_2", "FISH_1_4", "FISH_1_5", "DUAL_AR"])
def test_version_enums_equal(name):
    jm, tm = jcfg.WhichModel[name], tcfg.WhichModel[name]
    assert tm.value == jm.value
    assert getattr(tm.fish_version, "value", None) == getattr(jm.fish_version, "value", None)
    assert tcfg.WhichLM.from_model(tm).value == jcfg.WhichLM.from_model(jm).value
    assert tcfg.WhichCodec.from_model(tm).value == jcfg.WhichCodec.from_model(jm).value
    tl, jl = tcfg.WhichLM.from_model(tm), jcfg.WhichLM.from_model(jm)
    assert getattr(tl.fish_version, "value", None) == getattr(jl.fish_version, "value", None)
    assert tl.uses_explicit_semantic_ids == jl.uses_explicit_semantic_ids


@pytest.mark.parametrize("version", ["1.2", "1.4", "1.5"])
def test_firefly_config_equal(version):
    """Every field of the port's codec config for the version, the
    backbone included, equal to the JAX config's (which also keeps
    win_length and the head's hop_length, read by nothing)."""
    j = jcfg.FireflyConfig.for_version(jcfg.FishVersion(version))
    t = tcfg.FireflyConfig.for_version(tcfg.FishVersion(version))
    for part in ("spec_transform", "backbone", "head", "quantizer"):
        tp, jp = dataclasses.asdict(getattr(t, part)), dataclasses.asdict(getattr(j, part))
        assert tp == {k: v for k, v in jp.items() if k in tp}, part
    assert t.version.value == j.version.value
    assert (t.frame_rate, t.samples_per_frame, t.quantizer.num_semantic_codebooks) == (
        j.frame_rate, j.samples_per_frame, j.quantizer.num_semantic_codebooks)
