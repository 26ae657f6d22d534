"""The port's finetune CLI (fish_speech_tpu_torch/cli/finetune.py) on the
CPU, against the JAX package's (tests/test_cli.py::test_finetune_cli):
one checkpoint directory (the tiny LM of tests/test_torch_checkpoint.py
in the upstream names, config.json and tests/test_api.py's word-level
tokenizer) and one dataset of three (transcript, codes) pairs.

After 4 steps at lr 1e-3 (warmup 1) both CLIs' model.safetensors hold
every value within one step's learning rate and all but 0.1% of them
within 1e-5 (tests/test_torch_train.py::assert_adam_close says why).
The port's `--resume` run equals its straight run bit for bit, and
a `--tp` that does not divide the head counts raises (training under a
mesh: tests/test_torch_train_parallel.py)."""

import pytest

pytest.importorskip("safetensors")
pytest.importorskip("tokenizers")

import dataclasses
import json
import sys

import numpy as np
import torch
from safetensors.numpy import load_file, save_file

from fish_speech_tpu.cli import finetune as jft
from fish_speech_tpu_torch.cli import finetune as tft
from fish_speech_tpu_torch.io.checkpoint import load_lm_params
from test_torch_checkpoint import JCFG, TCFG, make_lm_state_dict
from test_torch_cli import _write_tokenizer
from test_torch_train import assert_adam_close

torch.set_num_threads(1)
LR = 1e-3


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ft_ckpt")
    save_file(make_lm_state_dict(JCFG, np.random.default_rng(0)), str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(dataclasses.asdict(JCFG)))
    _write_tokenizer(d / "tokenizer.json", JCFG)
    return d


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("ft_data")
    rng = np.random.default_rng(3)
    for i, text in enumerate(["hello world .", "speak the text .", "hello the provided text ."]):
        np.save(d / f"s{i}.npy", rng.integers(0, JCFG.codebook_size,
                                              size=(JCFG.num_codebooks, 6), dtype=np.uint32))
        (d / f"s{i}.txt").write_text(text)
    return d


def _argv(ckpt, data, out, *extra):
    return ["--checkpoint", str(ckpt), "--data", str(data), "--out", str(out),
            "--batch-size", "2", "--seq-len", "48", "--lr", str(LR), "--warmup", "1",
            "--seed", "11", *extra]


def test_finetune_matches_jax_cli(checkpoint_dir, dataset, tmp_path, monkeypatch):
    jout, tout = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["prog"] + _argv(checkpoint_dir, dataset, jout,
                                                      "--steps", "4"))
    jft.main()
    tft.main(_argv(checkpoint_dir, dataset, tout, "--steps", "4", "--device", "cpu"))
    for name in ("config.json", "tokenizer.json"):
        assert (tout / name).read_bytes() == (checkpoint_dir / name).read_bytes()
    ref, got = load_file(str(jout / "model.safetensors")), load_file(str(tout / "model.safetensors"))
    assert all(got[k].dtype == ref[k].dtype == np.float32 for k in ref)
    assert_adam_close(got, ref, LR)
    # training moved the weights, and the port's loader reads them back
    before = load_lm_params(checkpoint_dir, TCFG, dtype=torch.float32, device="cpu")
    after = load_lm_params(tout, TCFG, dtype=torch.float32, device="cpu")
    assert not torch.allclose(before["slow"]["wqkv"], after["slow"]["wqkv"])


def test_finetune_resume_bit_exact(checkpoint_dir, dataset, tmp_path, capsys):
    """Interrupted after 2 of 4 steps (--save-every 1) and resumed: the
    final checkpoint equals the straight run's bit for bit (moments, the
    schedule's count and the data order all snapshot)."""
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    tft.main(_argv(checkpoint_dir, dataset, straight, "--steps", "4", "--device", "cpu",
                   "--log-every", "1"))
    tft.main(_argv(checkpoint_dir, dataset, resumed, "--steps", "2", "--save-every", "1",
                   "--device", "cpu"))
    assert (resumed / "train_state.npz").exists()
    capsys.readouterr()
    tft.main(_argv(checkpoint_dir, dataset, resumed, "--steps", "4", "--resume",
                   "--device", "cpu"))
    assert "resumed from" in capsys.readouterr().out
    a = load_file(str(straight / "model.safetensors"))
    b = load_file(str(resumed / "model.safetensors"))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_finetune_returns_its_logged_steps(checkpoint_dir, dataset, tmp_path):
    """finetune(tokenizer, args): one record a logged step, with the
    metrics, the batch's real tokens and the seconds since the loop
    began."""
    from fish_speech_tpu_torch.cli.llama_generate import load_tokenizer

    args = tft.build_parser().parse_args(
        _argv(checkpoint_dir, dataset, tmp_path / "out", "--steps", "3", "--log-every", "1",
              "--device", "cpu", "--no-remat"))
    records = tft.finetune(load_tokenizer(checkpoint_dir / "tokenizer.json"), args)
    assert [r["step"] for r in records] == [0, 1, 2]
    for r in records:
        assert np.isfinite(r["loss"]) and r["grad_norm"] > 0 and r["tokens"] > 0
    assert 0 < records[0]["seconds"] <= records[-1]["seconds"]


def test_finetune_tp_raises(checkpoint_dir, dataset, tmp_path):
    """--tp 3 does not divide the 4 q and 2 KV heads: it raises before
    training, as JAX's sharding does, instead of training on one device."""
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        tft.main(_argv(checkpoint_dir, dataset, tmp_path / "out", "--steps", "1", "--tp", "3",
                       "--device", "cpu"))
    assert not (tmp_path / "out").exists()
