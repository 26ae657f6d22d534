"""Offline audio-quality proxies: numeric stand-ins for decisions that
cannot be made by ear here (the int8 serving default of
`utils/int8_policy.py`).

Counterpart of `fish_speech_tpu/utils/quality.py`: PCM metrics (MSE, max
error, SNR), teacher-forced argmax predictions of a DualAR parameter set
(dense or int8) and their agreement, and the L1 distance of two signals
in log-mel space, which follows perceptual differences far better than
waveform error (inaudible phase drift gives a large PCM MSE but a small
mel distance).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fish_speech_tpu_torch.audio.mel import LogMelSpectrogram
from fish_speech_tpu_torch.ops.norms import rms_norm
from fish_speech_tpu_torch.ops.quant import matmul as _mm
from fish_speech_tpu_torch.train.loss import fast_forward_teacher, slow_forward_full


def pcm_metrics(a: np.ndarray, b: np.ndarray) -> Dict[str, float]:
    """mse, max_err and snr_db (a as the signal, a - b as the noise)
    between two mono PCM arrays, cut to their common length."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    n = min(a.shape[0], b.shape[0])
    a, b = a[:n], b[:n]
    err = a - b
    mse = float(np.mean(err**2)) if n else 0.0
    sig = float(np.mean(a**2)) if n else 0.0
    snr = float(10.0 * np.log10(sig / mse)) if mse > 0 and sig > 0 else np.inf
    return {"mse": mse, "max_err": float(np.max(np.abs(err))) if n else 0.0, "snr_db": snr}


@torch.inference_mode()
def teacher_forced_predictions(params, cfg, token_cfg, tokens: np.ndarray):
    """Per-position argmax predictions of a parameter set scored on a
    given (C+1, S) token sequence (the engine's raw LM tokens, prompt and
    generated frames), on the device the parameters lie on.

    Returns numpy (slow_pred (S-1,), fast_pred (S-1, C), audio_mask
    (S-1,)): slow_pred[t] is the next-semantic argmax at position t+1,
    fast_pred[t] the codebook argmaxes of frame t+1 given its true
    earlier codebooks, audio_mask[t] whether frame t+1 is an audio frame.
    """
    dev = params["embeddings"].device
    tok = torch.as_tensor(np.asarray(tokens, np.int32), device=dev)[None]  # (1, C+1, S)
    _, cp1, s = tok.shape
    c = cp1 - 1
    seq_lens = torch.full((1,), s, dtype=torch.int32, device=dev)
    hidden = slow_forward_full(params, cfg, token_cfg, tok, seq_lens)  # (1, S, D)
    slow_out = rms_norm(hidden, params["norm"], cfg.norm_eps)
    slow_pred = torch.argmax(_mm(slow_out[:, :-1, :], params["output"]).float(), dim=-1)
    cb_targets = tok[:, 1:, 1:].transpose(1, 2)  # (1, S-1, C)
    fast_logits = fast_forward_teacher(params, cfg, hidden[0, :-1, :], cb_targets[0])
    fast_pred = torch.argmax(fast_logits, dim=-1).reshape(s - 1, c)
    sem_next = np.asarray(tokens)[0, 1:]
    if token_cfg.semantic_end_id is not None:
        audio_mask = (sem_next >= token_cfg.semantic_start_id) & (
            sem_next <= token_cfg.semantic_end_id)
    else:
        audio_mask = sem_next == token_cfg.semantic_start_id
    return slow_pred[0].cpu().numpy(), fast_pred.cpu().numpy(), np.asarray(audio_mask)


def teacher_forced_agreement(preds_a, preds_b) -> Dict[str, float]:
    """Argmax agreement of two teacher_forced_predictions results, each
    position under the same context (a free-running comparison measures
    where two trajectories first part, not the local decisions).

    Returns {"slow", "fast", "combined", "n"}: slow-head agreement over
    every next-position prediction, fast-head agreement over the audio
    frames' codebook predictions, and the fraction over both."""
    slow_a, fast_a, mask = preds_a
    slow_b, fast_b, _ = preds_b
    slow_match = slow_a == slow_b
    fast_match = (fast_a == fast_b)[mask]
    n_slow, n_fast = slow_match.size, fast_match.size
    n = n_slow + n_fast
    return {
        "slow": float(slow_match.mean()) if n_slow else 1.0,
        "fast": float(fast_match.mean()) if n_fast else 1.0,
        "combined": float((slow_match.sum() + fast_match.sum()) / n) if n else 1.0,
        "n": float(n),
    }


def mel_l1_distance(a: np.ndarray, b: np.ndarray, spec_cfg, device="cuda") -> float:
    """Mean absolute log-mel difference of two mono PCM arrays at
    spec_cfg's sample rate (the codec's own analysis front end)."""
    spec = LogMelSpectrogram(spec_cfg, device=device)
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    n = min(a.shape[0], b.shape[0])
    ma, mb = spec(a[:n])[0], spec(b[:n])[0]
    t = min(ma.shape[-1], mb.shape[-1])
    return float((ma[..., :t] - mb[..., :t]).abs().mean())
