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
(train/checkpoint.py). Without a config.json the checkpoint's version
gives the config (llama_generate.load_config), where the JAX CLI takes
Fish 1.2's for every version.

With more than one rank, training runs under a (dp, tp) mesh, as the JAX
CLI does with more than one device: `--tp` sets the tp width, dp is the
ranks over tp. The ranks are the world FISH_TPU_COORDINATOR /
FISH_TPU_NUM_PROCESSES / FISH_TPU_PROCESS_ID describe, with
FISH_TPU_LOCAL_NUM_PROCESSES / FISH_TPU_LOCAL_PROCESS_ID where it spans
hosts (each rank runs this command, started by a cluster's launcher), or,
with no coordinator and more than one card visible, one rank a card of
this host, which this command starts. `--backend gloo` lets ranks share
a card (NCCL refuses that). Every rank draws the same data order from
`--seed`; each host builds its block of the global batch
(`--batch-size` / hosts rows) and each rank keeps its dp rows of the
global batch (`shard_batch`), so a mesh, on one host or across hosts,
sees the batches one device would. (The JAX CLI hands each process the
whole seeded batch as its host's rows, so on two processes its global
batch holds every row twice.) Where dp, or the hosts, do not divide
`--batch-size`, rank 0 says so and trains on one device, as the JAX CLI
does. Only rank 0 prints, snapshots and writes the checkpoint (gathered
from the shards); a snapshot of one mesh resumes at another, and must
lie on storage every host sees.

  FISH_TPU_COORDINATOR=127.0.0.1:29500 FISH_TPU_NUM_PROCESSES=2 \\
  FISH_TPU_PROCESS_ID=<rank> python -m fish_speech_tpu_torch.cli.finetune \\
      ... --tp 2 --backend gloo        # two ranks on one card
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from fish_speech_tpu_torch.cli.llama_generate import load_config, load_tokenizer
from fish_speech_tpu_torch.config import TokenConfig, WhichLM, WhichModel
from fish_speech_tpu_torch.device import host_to_device, resolve_device
from fish_speech_tpu_torch.io.checkpoint import load_lm_params, save_lm_params
from fish_speech_tpu_torch.parallel import distributed as pdist
from fish_speech_tpu_torch.parallel.mesh import check_divisible
from fish_speech_tpu_torch.text.prompt import FISH_1_5_SYSPROMPT, PromptEncoder, load_prompt_tokens
from fish_speech_tpu_torch.train import TrainConfig, init_train_state, make_train_step
from fish_speech_tpu_torch.train.checkpoint import (
    gather_params, load_train_state, save_train_state, visible)
from fish_speech_tpu_torch.train.step import shard_batch


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
                   help="tensor-parallel width of the mesh when there is more than one rank")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="the world's collectives (default: nccl on cards, gloo on the CPU); "
                        "gloo lets ranks share a card")
    p.add_argument("--no-remat", action="store_true",
                   help="keep the slow layers' activations for the backward "
                        "instead of running each layer again there")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def load_dataset(data_dir: Path, encoder: PromptEncoder, lm: WhichLM, num_codebooks: int,
                 seq_len: int, sysprompt: bool, say=print) -> List[np.ndarray]:
    """Encode every pair to a (C+1, <= seq_len) int32 sequence; `say`
    prints what is skipped or cut."""
    samples = []
    for npy in sorted(Path(data_dir).glob("*.npy")):
        txt = npy.with_suffix(".txt")
        if not txt.exists():
            say(f"skipping {npy.name}: no matching .txt transcript")
            continue
        codes = load_prompt_tokens(npy, num_codebooks)
        parts = []
        if sysprompt and lm == WhichLM.FISH_1_5:
            parts.append(encoder.encode_text("system", FISH_1_5_SYSPROMPT))
        parts.append(encoder.encode_conditioning_prompt(txt.read_text().strip(), codes))
        seq = np.concatenate(parts, axis=1).astype(np.int32)
        if seq.shape[1] > seq_len:
            say(f"truncating {npy.name}: {seq.shape[1]} -> {seq_len} tokens")
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


def train_mesh(args: argparse.Namespace):
    """The (dp, tp) mesh over the world's ranks where it has more than
    one, else None; None too where dp, or the world's hosts, do not
    divide the batch (rank 0 prints JAX's message and trains on one
    device)."""
    if not torch.distributed.is_initialized() or torch.distributed.get_world_size() == 1:
        if args.tp > 1:
            print(f"one rank: --tp {args.tp} has no ranks to split over; training on one device")
        return None
    n = torch.distributed.get_world_size()
    if n % args.tp:
        raise ValueError(f"--tp {args.tp} does not divide the world's {n} ranks")
    dp, hosts = n // args.tp, pdist.host_layout().hosts
    unsplit = (f"dp={dp}" if args.batch_size % dp
               else f"the {hosts} hosts" if args.batch_size % hosts else None)
    if unsplit is not None:
        if pdist.rank0():
            print(f"batch size {args.batch_size} not divisible by {unsplit}; "
                  "training on one device")
        return None
    mesh = pdist.global_mesh(args.tp, "cpu" if args.device == "cpu" else None)
    if pdist.rank0():
        print(f"mesh: {{'dp': {mesh.size(0)}, 'tp': {mesh.size(1)}}}")
    return mesh


def finetune(tokenizer, args: argparse.Namespace) -> List[Dict[str, float]]:
    """Train as `args` say (build_parser's flags) with `tokenizer`, and
    write the checkpoint to args.out. Returns one record a logged step:
    the metrics as floats, "step", "seconds" since the loop began (each
    log reads the metrics, so it waits for that step) and "tokens" (the
    batch's real tokens, the sum of its lengths). In a world of ranks,
    every rank calls it and trains under the mesh (`train_mesh`); the
    records are rank 0's, the other ranks get none (nor, where the
    mesh falls back to one device, do they train)."""
    device = resolve_device(args.device)
    model = WhichModel(args.fish_version)
    lm = WhichLM.from_model(model)
    ckpt = Path(args.checkpoint)
    cfg = load_config(ckpt, model)
    check_divisible(cfg, args.tp)
    token_cfg = TokenConfig.from_tokenizer(lm, tokenizer, cfg)
    mesh = train_mesh(args)
    if mesh is None and not pdist.rank0():
        return []
    say = print if pdist.rank0() else (lambda *a, **k: None)

    t0 = time.perf_counter()
    # float32 for exact AdamW arithmetic; the result serves in bf16 as usual
    params = load_lm_params(ckpt, cfg, dtype=torch.float32, device=device)
    say(f"Model loaded in {time.perf_counter() - t0:.1f}s")

    encoder = PromptEncoder(tokenizer, cfg.num_codebooks, lm)
    samples = load_dataset(Path(args.data), encoder, lm, cfg.num_codebooks, args.seq_len,
                           not args.no_sysprompt, say)
    seq_len = max(s.shape[1] for s in samples)
    say(f"{len(samples)} samples, padded length {seq_len}")

    tcfg = TrainConfig(learning_rate=args.lr, weight_decay=args.weight_decay,
                       grad_clip=args.grad_clip, warmup_steps=args.warmup,
                       total_steps=args.steps, fast_weight=args.fast_weight,
                       remat=not args.no_remat)
    params, opt_state = init_train_state(params, tcfg, mesh=mesh, cfg=cfg)
    step = make_train_step(cfg, token_cfg, tcfg, mesh=mesh)

    out = Path(args.out)
    state_path = out / "train_state.npz"
    rng = np.random.default_rng(args.seed)
    order: list = []
    start_step = 0
    # this host's block of every global batch: all of it on one host
    lo, hi = pdist.host_rows(args.batch_size) if mesh is not None else (0, args.batch_size)
    if args.resume and any(visible(state_path, mesh)):
        start_step, params, opt_state, saved_rng, extra = load_train_state(
            state_path, params, opt_state, mesh=mesh, cfg=cfg)
        if saved_rng is not None:
            rng = saved_rng
        order = list(extra.get("order", []))
        say(f"resumed from {state_path} at step {start_step}")

    records = []
    t0 = time.perf_counter()
    for i in range(start_step, args.steps):
        if len(order) < args.batch_size:
            order = list(rng.permutation(len(samples)))
        # wrap around for datasets smaller than the batch
        idx = [order.pop() for _ in range(min(args.batch_size, len(order)))]
        while len(idx) < args.batch_size:
            idx.append(int(rng.integers(len(samples))))
        batch = make_batch(samples, idx[lo:hi], seq_len, token_cfg.pad_id, device)
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        params, opt_state, metrics = step(params, opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            records.append(dict(m, step=i, seconds=dt,
                                tokens=int(sum(samples[j].shape[1] for j in idx))))
            say(f"step {i:5d}  loss {m['loss']:.4f} "
                  f"(slow {m['slow_loss']:.4f} fast {m['fast_loss']:.4f}) "
                  f"acc slow {m['slow_acc']:.3f} fast {m['fast_acc']:.3f} "
                  f"grad {m['grad_norm']:.3f}  {dt:.1f}s")
        if args.save_every and (i + 1) % args.save_every == 0:
            out.mkdir(parents=True, exist_ok=True)
            save_train_state(state_path, step=i + 1, params=params, opt_state=opt_state,
                             rng=rng, extra={"order": [int(x) for x in order]}, mesh=mesh,
                             cfg=cfg)
            say(f"snapshot: {state_path} (step {i + 1})")

    params = gather_params(params, mesh, cfg)
    if pdist.rank0():
        out.mkdir(parents=True, exist_ok=True)
        save_lm_params(out / "model.safetensors", params, cfg)
        for name in ("config.json", "tokenizer.json"):
            if (ckpt / name).exists():
                shutil.copy(ckpt / name, out / name)
        if not (ckpt / "config.json").exists():
            (out / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
        say(f"saved {out / 'model.safetensors'}")
    if mesh is not None:
        torch.distributed.barrier()
    return records if pdist.rank0() else []


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    backend = args.backend or ("gloo" if device.type == "cpu" else None)
    address, procs = None, []
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if pdist.COORDINATOR_ENV not in os.environ and cards > 1:
        # one rank a card: this process is rank 0
        address, procs = pdist.launch_ranks(cards, "fish_speech_tpu_torch.cli.finetune", argv)
    owned = not torch.distributed.is_initialized()  # else a caller's world
    try:
        if address is not None:
            pdist.initialize_distributed(address, cards, 0, backend=backend)
        else:
            pdist.initialize_distributed(backend=backend)
        finetune(load_tokenizer(Path(args.checkpoint) / "tokenizer.json"), args)
    finally:
        if owned and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        pdist.wait_ranks(procs, timeout_s=600.0)


if __name__ == "__main__":
    main()
