"""Carried-state streaming primitives for causal 1-D conv stacks, and
the lock that every codec call takes.

Counterpart of `fish_speech_tpu/models/codec/stream_conv.py`, shared by
the Firefly stream (`firefly_stream.py`) and Mimi (`mimi.py`). Feeding a
sequence in chunks of any sizes gives the concatenation that the
whole-sequence (batch) decode gives, because the only time-coupled ops
of the Fish 1.4+ and Mimi decode paths are

* a causal conv (left zero-pad of (k-1)*d + 1 - stride): the stream
  carries the last pad_left input samples, zeros at first, which is the
  batch path's zero pad, and
* a causal transposed conv (right trim of k - stride): the trimmed tail
  is the current chunk's contribution to the next chunk's first samples,
  so the stream carries it (bias-free) and overlap-adds it.

Weights keep torch layouts: conv (O, I/groups, K), transposed conv
(I, O/groups, K). `F.conv_transpose1d` takes `groups` itself, so no
zero-insert formulation is needed.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Held by every codec call of any thread while it queues its work on the
# card (encode, decode, streaming steps, the central vocoder's feeds),
# and by `_tf32` blocks: no codec work of another thread is queued while
# a block has the process-wide TF32 switches set.
_CODEC_LOCK = threading.RLock()


@contextlib.contextmanager
def _tf32(allow: bool):
    """cuDNN convolutions and cuBLAS float32 matmuls with TF32 allowed or
    not, for the block only. (`torch.backends.cudnn.flags` would also
    reset cuDNN's other switches to its own defaults.) The two switches
    are process-wide, and the switches are read when work is queued: a
    block holds the codec lock, so blocks on several threads run one at
    a time (none restores a value another set) and no other thread's
    codec work is queued under a block's setting (a server's encode
    beside the central vocoder's feeds)."""
    with _CODEC_LOCK:
        conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = allow
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def conv_state(batch: int, c_in: int, k: int, *, stride: int = 1, dilation: int = 1,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Zero carried input tail of `stream_conv1d`: (batch, c_in, pad_left)."""
    pad_left = (k - 1) * dilation + 1 - stride
    return torch.zeros((batch, c_in, pad_left), dtype=dtype, device=device)


def conv_transpose_state(batch: int, c_out: int, k: int, *, stride: int,
                         dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Zero carried output tail of `stream_conv_transpose1d`:
    (batch, c_out, max(k - stride, 0))."""
    return torch.zeros((batch, c_out, max(k - stride, 0)), dtype=dtype, device=device)


def stream_conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  state: torch.Tensor, *, stride: int = 1, dilation: int = 1,
                  groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming causal conv: `state` holds the previous pad_left input
    samples. The chunk length must be a multiple of `stride`. Returns
    (out, new_state); the state is a copy, so it holds no chunk alive."""
    pad_left = (w.shape[-1] - 1) * dilation + 1 - stride
    if pad_left:
        xin = torch.cat([state, x], dim=-1)
        new_state = xin[..., xin.shape[-1] - pad_left:].contiguous()
    else:
        xin, new_state = x, state
    return F.conv1d(xin, w, b, stride=stride, dilation=dilation, groups=groups), new_state


def conv_transpose_raw(x: torch.Tensor, w: torch.Tensor, *, stride: int,
                       groups: int = 1) -> torch.Tensor:
    """The full (untrimmed, bias-free) transposed conv: x (B, C_in, T),
    w (C_in, C_out/groups, K) -> (B, C_out, (T - 1) * stride + K)."""
    return F.conv_transpose1d(x, w, None, stride=stride, groups=groups)


def stream_conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                            state: torch.Tensor, *, stride: int,
                            groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming causal transposed conv (right-trim convention): overlap-add
    the carried bias-free tail onto this chunk's head, emit T*stride
    samples, carry the new k - stride tail, then add the bias. Returns
    (out, new_state)."""
    out = conv_transpose_raw(x, w, stride=stride, groups=groups)
    tail = max(w.shape[-1] - stride, 0)
    if tail:
        out[..., :tail] += state
        new_state = out[..., out.shape[-1] - tail:].contiguous()
        out = out[..., :out.shape[-1] - tail]
    else:
        new_state = state
    if b is not None:
        out = out + b[None, :, None]
    return out, new_state


def tree_where(mask: torch.Tensor, a, b):
    """Per batch row: a where mask, else b, over two state trees of equal
    structure (nested dicts, lists and tuples of (B, ...) tensors)."""
    if isinstance(a, dict):
        return {k: tree_where(mask, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(tree_where(mask, x, y) for x, y in zip(a, b))
    return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


class StreamSessionBase:
    """Session mechanics of a carried-state streaming codec.

    feed(codes (K, t) or (B, K, t)) returns the PCM of exactly those t
    frames; the concatenation over calls equals the codec's batch decode
    of the whole code sequence. A feed is split into pieces of at most
    `max_step` frames, which bounds a step's working memory, and all its
    pieces are read back by one copy at the end. The piece sizes do not
    change the PCM (every op is chunk-size invariant).

    Subclasses implement `_template()`, the zero state for the current
    batch size, shared and never written; the codec provides
    `decode_step_async(codes, state) -> (device pcm, new_state)`.
    """

    def __init__(self, codec, batch: int, max_step_frames: int):
        self.codec = codec
        self.batch = batch
        self.max_step = max(1, int(max_step_frames))
        self.state = self._template()

    def _template(self):
        raise NotImplementedError

    @staticmethod
    def _batched(codes) -> np.ndarray:
        codes = np.asarray(codes)
        return codes[None] if codes.ndim == 2 else codes

    def feed(self, codes) -> np.ndarray:
        """codes (K, t) or (B, K, t) -> (B, t * spf) float32 PCM."""
        codes = self._batched(codes)
        parts = []
        for s in range(0, codes.shape[-1], self.max_step):
            pcm, self.state = self.codec.decode_step_async(
                codes[..., s:s + self.max_step], self.state)
            parts.append(pcm)
        if not parts:
            return np.zeros((codes.shape[0], 0), np.float32)
        return torch.cat(parts, dim=-1).float().cpu().numpy()

    def feed_async(self, codes, pad_to: Optional[int] = None):
        """One streaming step, returned as a device tensor (B, t' * spf)
        without waiting for it, with t, the real frame count. pad_to:
        right-pad the codes with zeros to this many frames (the decode
        path is causal, so padding cannot change the real frames'
        samples; the caller trims the last feed's tail)."""
        codes = self._batched(codes)
        t = codes.shape[-1]
        if pad_to is not None and t < pad_to:
            codes = np.concatenate(
                [codes, np.zeros((*codes.shape[:-1], pad_to - t), codes.dtype)], axis=-1)
        audio, self.state = self.codec.decode_step_async(codes, self.state)
        return audio, t

    def reset(self, batch: Optional[int] = None) -> None:
        """Restart the stream; keeps the batch size unless given one."""
        if batch is not None:
            self.batch = batch
        self.state = self._template()
