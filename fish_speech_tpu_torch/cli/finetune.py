"""Finetune a DualAR checkpoint on (transcript, codec tokens) pairs, on
the card.

The port's counterpart of `fish_speech_tpu/cli/finetune.py`, with its
flags, prompt layout, truncation, data order, logging and snapshots, and
`--device` (default cuda; without a card it raises; `--device cpu`
trains on the CPU). The data are `.npy` codec tokens as the encoder CLI
writes them, each beside a `.txt` transcript; each pair is encoded with
the prompt layout serving uses (the Fish 1.5 system prompt unless
`--no-sysprompt`, a user turn, the assistant's VQ turn), so the model
trains on sequences laid out as its serving prompts. The weights are
trained in float32 and written as `model.safetensors` in the upstream
names, with `config.json` and `tokenizer.json`, so the output directory
serves as it is.

Usage:
  python -m fish_speech_tpu_torch.cli.finetune \\
      --checkpoint checkpoints/fish-speech-1.5 --fish-version 1.5 \\
      --data dataset/ --out finetuned/ \\
      --steps 500 --batch-size 4 --seq-len 512 --lr 1e-5

`--save-every N` snapshots the whole train state (parameters, AdamW
moments, the schedule's count, the data-order RNG and permutation) to
<out>/train_state.npz; rerun with `--resume` to continue bit for bit
(train/checkpoint.py). Training runs on one device: `--tp` other than 1
raises. `parallel/` shards serving; training under a mesh (the train
half of module 10) is the slice still to come. Without a config.json the checkpoint's version
gives the config (llama_generate.load_config), where the JAX CLI takes
Fish 1.2's for every version.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from fish_speech_tpu_torch.cli.llama_generate import load_config, load_tokenizer
from fish_speech_tpu_torch.config import TokenConfig, WhichLM, WhichModel
from fish_speech_tpu_torch.device import host_to_device, resolve_device
from fish_speech_tpu_torch.io.checkpoint import load_lm_params, save_lm_params
from fish_speech_tpu_torch.text.prompt import FISH_1_5_SYSPROMPT, PromptEncoder, load_prompt_tokens
from fish_speech_tpu_torch.train import TrainConfig, init_train_state, make_train_step
from fish_speech_tpu_torch.train.checkpoint import load_train_state, save_train_state


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="finetune DualAR on (transcript, codec tokens) pairs")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--fish-version", default="1.5", choices=["1.2", "1.4", "1.5", "dual_ar"])
    p.add_argument("--data", required=True, help="dir of <name>.txt + <name>.npy pairs")
    p.add_argument("--out", required=True, help="output checkpoint dir")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=512,
                   help="static training length; longer samples truncate")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--warmup", type=int, default=50)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--fast-weight", type=float, default=1.0)
    p.add_argument("--no-sysprompt", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--save-every", type=int, default=0,
                   help="snapshot train state to <out>/train_state.npz "
                        "every N steps (0 = only the final checkpoint)")
    p.add_argument("--resume", action="store_true",
                   help="resume from <out>/train_state.npz if present; "
                        "continues bit-exactly (optimizer moments, LR "
                        "schedule, and data order all restored)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width; only 1 (one device) is ported for training")
    p.add_argument("--no-remat", action="store_true",
                   help="keep the slow layers' activations for the backward "
                        "instead of running each layer again there")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def _one_device(args: argparse.Namespace) -> None:
    if args.tp != 1:
        raise ValueError(f"--tp {args.tp}: training under a mesh (the train half of module 10, "
                         "its slice still to come) is not ported; parallel/ shards serving "
                         "only, and this finetune trains on one device")


def load_dataset(data_dir: Path, encoder: PromptEncoder, lm: WhichLM, num_codebooks: int,
                 seq_len: int, sysprompt: bool) -> List[np.ndarray]:
    """Encode every pair to a (C+1, <= seq_len) int32 sequence."""
    samples = []
    for npy in sorted(Path(data_dir).glob("*.npy")):
        txt = npy.with_suffix(".txt")
        if not txt.exists():
            print(f"skipping {npy.name}: no matching .txt transcript")
            continue
        codes = load_prompt_tokens(npy, num_codebooks)
        parts = []
        if sysprompt and lm == WhichLM.FISH_1_5:
            parts.append(encoder.encode_text("system", FISH_1_5_SYSPROMPT))
        parts.append(encoder.encode_conditioning_prompt(txt.read_text().strip(), codes))
        seq = np.concatenate(parts, axis=1).astype(np.int32)
        if seq.shape[1] > seq_len:
            print(f"truncating {npy.name}: {seq.shape[1]} -> {seq_len} tokens")
            seq = seq[:, :seq_len]
        samples.append(seq)
    if not samples:
        raise SystemExit(f"no .txt/.npy pairs found in {data_dir}")
    return samples


def make_batch(samples, idx, seq_len: int, pad_id: int, device="cpu") -> Dict[str, torch.Tensor]:
    """Right-pad the selected samples to (B, C+1, seq_len) on `device`."""
    c1 = samples[0].shape[0]
    tokens = np.zeros((len(idx), c1, seq_len), np.int32)
    tokens[:, 0, :] = pad_id
    seq_lens = np.zeros((len(idx),), np.int32)
    for row, i in enumerate(idx):
        n = samples[i].shape[1]
        tokens[row, :, :n] = samples[i]
        seq_lens[row] = n
    return {"tokens": host_to_device(tokens, device), "seq_lens": host_to_device(seq_lens, device)}


def finetune(tokenizer, args: argparse.Namespace) -> List[Dict[str, float]]:
    """Train as `args` say (build_parser's flags) with `tokenizer`, and
    write the checkpoint to args.out. Returns one record a logged step:
    the metrics as floats, "step", "seconds" since the loop began (each
    log reads the metrics, so it waits for that step) and "tokens" (the
    batch's real tokens, the sum of its lengths)."""
    _one_device(args)
    device = resolve_device(args.device)
    model = WhichModel(args.fish_version)
    lm = WhichLM.from_model(model)
    ckpt = Path(args.checkpoint)
    cfg = load_config(ckpt, model)
    token_cfg = TokenConfig.from_tokenizer(lm, tokenizer, cfg)

    t0 = time.perf_counter()
    # float32 for exact AdamW arithmetic; the result serves in bf16 as usual
    params = load_lm_params(ckpt, cfg, dtype=torch.float32, device=device)
    print(f"Model loaded in {time.perf_counter() - t0:.1f}s")

    encoder = PromptEncoder(tokenizer, cfg.num_codebooks, lm)
    samples = load_dataset(Path(args.data), encoder, lm, cfg.num_codebooks, args.seq_len,
                           not args.no_sysprompt)
    seq_len = max(s.shape[1] for s in samples)
    print(f"{len(samples)} samples, padded length {seq_len}")

    tcfg = TrainConfig(learning_rate=args.lr, weight_decay=args.weight_decay,
                       grad_clip=args.grad_clip, warmup_steps=args.warmup,
                       total_steps=args.steps, fast_weight=args.fast_weight,
                       remat=not args.no_remat)
    params, opt_state = init_train_state(params, tcfg)
    step = make_train_step(cfg, token_cfg, tcfg)

    out = Path(args.out)
    state_path = out / "train_state.npz"
    rng = np.random.default_rng(args.seed)
    order: list = []
    start_step = 0
    if args.resume and state_path.exists():
        start_step, params, opt_state, saved_rng, extra = load_train_state(
            state_path, params, opt_state)
        if saved_rng is not None:
            rng = saved_rng
        order = list(extra.get("order", []))
        print(f"resumed from {state_path} at step {start_step}")

    records = []
    t0 = time.perf_counter()
    for i in range(start_step, args.steps):
        if len(order) < args.batch_size:
            order = list(rng.permutation(len(samples)))
        # wrap around for datasets smaller than the batch
        idx = [order.pop() for _ in range(min(args.batch_size, len(order)))]
        while len(idx) < args.batch_size:
            idx.append(int(rng.integers(len(samples))))
        batch = make_batch(samples, idx, seq_len, token_cfg.pad_id, device)
        params, opt_state, metrics = step(params, opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            records.append(dict(m, step=i, seconds=dt,
                                tokens=int(sum(samples[j].shape[1] for j in idx))))
            print(f"step {i:5d}  loss {m['loss']:.4f} "
                  f"(slow {m['slow_loss']:.4f} fast {m['fast_loss']:.4f}) "
                  f"acc slow {m['slow_acc']:.3f} fast {m['fast_acc']:.3f} "
                  f"grad {m['grad_norm']:.3f}  {dt:.1f}s")
        if args.save_every and (i + 1) % args.save_every == 0:
            out.mkdir(parents=True, exist_ok=True)
            save_train_state(state_path, step=i + 1, params=params, opt_state=opt_state,
                             rng=rng, extra={"order": [int(x) for x in order]})
            print(f"snapshot: {state_path} (step {i + 1})")

    out.mkdir(parents=True, exist_ok=True)
    save_lm_params(out / "model.safetensors", params, cfg)
    for name in ("config.json", "tokenizer.json"):
        if (ckpt / name).exists():
            shutil.copy(ckpt / name, out / name)
    if not (ckpt / "config.json").exists():
        (out / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    print(f"saved {out / 'model.safetensors'}")
    return records


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    _one_device(args)
    resolve_device(args.device)
    finetune(load_tokenizer(Path(args.checkpoint) / "tokenizer.json"), args)


if __name__ == "__main__":
    main()
