"""Firefly codec facade: 44.1 kHz audio -> codes (encode) and codes ->
PCM (decode).

Counterpart of `fish_speech_tpu/models/codec/firefly.py`, with the JAX
package's parameter tree: {"backbone": ConvNeXt encoder, "quantizer":
{"downsample", "upsample", "rvqs": [{"project_in", "project_out"}]},
"head": HiFiGAN}.

Encode: log-mel per row (`audio/mel.py`), the rows right-padded to the
longest with log(1e-5) (what silence gives), the backbone, the
downsample stack and grouped residual FSQ. The JAX encode pads the mel
further, to a compile bucket; the port encodes at the longest row's
length. Fish 1.4+ convolutions are causal, so the kept codes are the
same either way; Fish 1.2's symmetric padding lets the last frames see
the bucket's padding, where the port's codes are those of an
exact-length encode. A float32 encode on the card runs its convolutions
and matmuls with TF32 off (on by default for cuDNN convolutions): TF32's
rounding moves the features and flips codes that lie near a rounding
tie.

Streaming (Fish 1.4+): `FireflyCodec.start_stream` opens a carried-state
session (`firefly_stream.py`) whose feeds concatenate to the batch
decode, each frame decoded once.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from fish_speech_tpu_torch.audio.mel import LogMelSpectrogram, num_frames
from fish_speech_tpu_torch.config import (
    BackboneConfig, FireflyConfig, FishVersion, HiFiGANConfig)
from fish_speech_tpu_torch.device import host_to_device, resolve_device, tree_to
from fish_speech_tpu_torch.models.codec.convnext import convnext_encoder
from fish_speech_tpu_torch.models.codec.firefly_stream import (
    firefly_decode_step, stream_state_init)
from fish_speech_tpu_torch.models.codec.hifigan import hifigan_forward
from fish_speech_tpu_torch.models.codec.quantizer import quantizer_decode, quantizer_encode
from fish_speech_tpu_torch.models.codec.stream_conv import (
    _CODEC_LOCK, StreamSessionBase, _tf32)


def firefly_decode(params: Dict, cfg: FireflyConfig, indices: torch.Tensor,
                   feature_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, num_codebooks, T) int codes -> (B, 1, T * ds * hop) PCM, with
    features and audio past each row's length zeroed."""
    b, _, t = indices.shape
    factor = cfg.quantizer.total_downsample
    if feature_lengths is None:
        feature_lengths = torch.full((b,), t, dtype=torch.int64, device=indices.device)
    z = quantizer_decode(indices, params["quantizer"], cfg.quantizer, cfg.version)
    mel_mask = (torch.arange(z.shape[-1], device=z.device)[None, :]
                < (feature_lengths * factor)[:, None])
    z = z * mel_mask[:, None, :].to(z.dtype)
    audio = hifigan_forward(z, params["head"], cfg.head, cfg.version)
    hop = cfg.spec_transform.hop_length
    audio_mask = (torch.arange(audio.shape[-1], device=audio.device)[None, :]
                  < (feature_lengths * factor * hop)[:, None])
    return audio * audio_mask[:, None, :].to(audio.dtype)


def firefly_encode_mel(params: Dict, cfg: FireflyConfig, mel: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, T) log-mel -> (B, num_codebooks, T // total_downsample)
    int32 codes."""
    mel = mel.to(params["backbone"]["stem"]["conv"]["w"].dtype)
    features = convnext_encoder(mel, params["backbone"], cfg.backbone, cfg.version)
    return quantizer_encode(features, params["quantizer"], cfg.quantizer, cfg.version)


# -- init (benchmarks without weights) --------------------------------------


def _normal(gen, shape, dtype, device, scale=0.02):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def _conv(gen, o, i, k, dtype, device) -> Dict:
    """A conv (O, I, K) with a zero bias."""
    return {"w": _normal(gen, (o, i, k), dtype, device),
            "b": torch.zeros((o,), dtype=dtype, device=device)}


def _norm(dim, dtype, device) -> Dict:
    return {"w": torch.ones((dim,), dtype=dtype, device=device),
            "b": torch.zeros((dim,), dtype=dtype, device=device)}


def _convnext_init(gen, dim, kernel_size, dtype, device) -> Dict:
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=device)  # noqa: E731
    return {
        "dwconv": _conv(gen, dim, 1, kernel_size, dtype, device),
        "norm": _norm(dim, dtype, device),
        "pwconv1": {"w": _normal(gen, (dim, dim * 4), dtype, device), "b": zeros(dim * 4)},
        "pwconv2": {"w": _normal(gen, (dim * 4, dim), dtype, device), "b": zeros(dim)},
        "gamma": torch.full((dim,), 1e-6, dtype=dtype, device=device),
    }


def _hifigan_init(gen, cfg: HiFiGANConfig, dtype, device) -> Dict:
    def conv(o, i, k):
        return _conv(gen, o, i, k, dtype, device)

    ch0 = cfg.upsample_initial_channel
    ups: List[Dict] = []
    resblocks: List[List[Dict]] = []
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        ci, co = ch0 // 2**i, ch0 // 2 ** (i + 1)
        ups.append({"w": _normal(gen, (ci, co, k), dtype, device),  # (I, O, K)
                    "b": torch.zeros((co,), dtype=dtype, device=device)})
        resblocks.append([
            {"convs1": [conv(co, co, rk) for _ in dil],
             "convs2": [conv(co, co, rk) for _ in dil]}
            for rk, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)
        ])
    ch_final = ch0 // 2 ** len(cfg.upsample_rates)
    return {
        "conv_pre": conv(ch0, cfg.num_mels, cfg.pre_conv_kernel_size),
        "ups": ups,
        "resblocks": resblocks,
        "conv_post": conv(1, ch_final, cfg.post_conv_kernel_size),
    }


def _backbone_init(gen, cfg: BackboneConfig, dtype, device) -> Dict:
    k, dims = cfg.kernel_size, cfg.dims
    return {
        "stem": {"conv": _conv(gen, dims[0], cfg.input_channels, k, dtype, device),
                 "norm": _norm(dims[0], dtype, device),
                 "blocks": [_convnext_init(gen, dims[0], k, dtype, device)
                            for _ in range(cfg.depths[0])]},
        "mid": [{"norm": _norm(dims[i - 1], dtype, device),
                 "conv": _conv(gen, dims[i], dims[i - 1], 1, dtype, device),
                 "blocks": [_convnext_init(gen, dims[i], k, dtype, device)
                            for _ in range(cfg.depths[i])]}
                for i in range(1, len(cfg.depths))],
        "final_norm": _norm(dims[-1], dtype, device),
    }


def init_firefly_params(cfg: FireflyConfig, seed: int = 1, dtype=torch.bfloat16,
                        device="cuda") -> Dict:
    """Random parameters of both directions from a seed, made on
    `device`, with the JAX initialiser's shapes and scales (not its
    draws). The decode halves are drawn first, so they do not depend on
    the encoder's shapes."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q = cfg.quantizer
    dims = q.all_dims
    dim_g = dims[-1] // q.n_groups
    d_cb = len(q.levels)
    upsample = [
        {"conv": {"w": _normal(gen, (dims[i + 1], dims[i], f), dtype, device),
                  "b": torch.zeros((dims[i],), dtype=dtype, device=device)},
         "block": _convnext_init(gen, dims[i], 7, dtype, device)}
        for i, f in enumerate(q.downsample_factor)
    ]
    rvqs = [
        {"project_out": {"w": _normal(gen, (d_cb, dim_g), dtype, device),
                         "b": torch.zeros((dim_g,), dtype=dtype, device=device)}}
        for _ in range(q.n_groups)
    ]
    head = _hifigan_init(gen, cfg.head, dtype, device)
    # the encode halves
    downsample = [
        {"conv": _conv(gen, dims[i + 1], dims[i], f, dtype, device),
         "block": _convnext_init(gen, dims[i + 1], 7, dtype, device)}
        for i, f in enumerate(q.downsample_factor)
    ]
    for g in rvqs:
        g["project_in"] = {"w": _normal(gen, (dim_g, d_cb), dtype, device),
                           "b": torch.zeros((d_cb,), dtype=dtype, device=device)}
    return {
        "backbone": _backbone_init(gen, cfg.backbone, dtype, device),
        "quantizer": {"downsample": downsample, "upsample": upsample, "rvqs": rvqs},
        "head": head,
    }


class FireflyCodec:
    """User-facing codec: audio (T,) or (B, T) -> codes, and codes (C, T)
    or (B, C, T) -> float32 PCM."""

    def __init__(self, params: Dict, cfg: FireflyConfig, *, device="cuda") -> None:
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg
        self.sample_rate = cfg.spec_transform.sample_rate
        self.spec_transform = LogMelSpectrogram(cfg.spec_transform, device=self.device)
        self._stream_templates: Dict[int, Dict] = {}  # batch -> zero stream state

    @property
    def samples_per_frame(self) -> int:
        return self.cfg.samples_per_frame

    @torch.inference_mode()
    def decode_tensor(self, codes: torch.Tensor) -> torch.Tensor:
        """(B, C, T) int codes on any device -> (B, T * spf) PCM on the
        codec's device, in the parameters' dtype."""
        codes = codes.to(self.device)
        with _CODEC_LOCK:
            return firefly_decode(self.params, self.cfg, codes)[:, 0, :]

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """codes (C, T) or (B, C, T) -> (B, T * spf) float32 PCM."""
        codes = np.asarray(codes)
        if codes.ndim == 2:
            codes = codes[None]
        audio = self.decode_tensor(torch.from_numpy(codes.astype(np.int64)))
        return audio.float().cpu().numpy()

    @torch.inference_mode()
    def encode(self, audio, *, allow_tf32: bool = False) -> np.ndarray:
        """audio (T,) or (B, T) float at 44.1 kHz -> (B, num_codebooks, T')
        int32 codes, T' the longest row's mel frames // total_downsample.
        allow_tf32: let a float32 encode on the card use TF32 (it moves
        codes; off by default)."""
        audio = np.atleast_2d(np.asarray(audio, dtype=np.float32))
        with _CODEC_LOCK:
            mels = [self.spec_transform(row)[0] for row in audio]
            t = max(m.shape[-1] for m in mels)
            if t < self.cfg.quantizer.total_downsample:  # shorter than one code frame
                return np.zeros((audio.shape[0], self.cfg.quantizer.num_semantic_codebooks, 0),
                                np.int32)
            mel = torch.full((audio.shape[0], self.cfg.spec_transform.n_mels, t),
                             math.log(1e-5), dtype=torch.float32, device=self.device)
            for i, m in enumerate(mels):
                mel[i, :, :m.shape[-1]] = m
            with _tf32(allow_tf32):
                codes = firefly_encode_mel(self.params, self.cfg, mel)
        return codes.cpu().numpy()

    def decode_tail(self, codes: np.ndarray, new_frames: int,
                    context_frames: int = 32) -> np.ndarray:
        """Windowed incremental decode: given all codes so far (C, T), the
        PCM of the last `new_frames` frames, decoded with `context_frames`
        of left context. The convs are causal, so with enough context the
        tail equals the whole-sequence decode's. A utility: streaming
        callers use start_stream, which decodes each frame once."""
        codes = np.asarray(codes)
        t = codes.shape[-1]
        new_frames = min(new_frames, t)
        start = max(t - new_frames - context_frames, 0)
        pcm = self.decode(codes[:, start:])[0]
        return pcm[(t - start - new_frames) * self.samples_per_frame:]

    def frames_for_samples(self, n_samples: int) -> int:
        """Code frames of n_samples of audio under the reference's framing."""
        st = self.cfg.spec_transform
        return num_frames(n_samples, st.n_fft, st.hop_length) // self.cfg.quantizer.total_downsample

    # -- streaming (carried state; Fish 1.4+ only) --------------------------

    @property
    def can_stream(self) -> bool:
        """Fish 1.4+ decode is causal; 1.2's symmetric padding is not."""
        return self.cfg.version != FishVersion.V1_2

    def start_stream(self, batch: int = 1, max_step_frames: int = 32) -> "FireflyStreamSession":
        """A carried-state decode session: feed code frames as they come and
        receive the PCM the batch decode gives for the growing prefix."""
        if not self.can_stream:
            raise ValueError("Fish 1.2 codec decode is not streamable")
        return FireflyStreamSession(self, batch, max_step_frames)

    def decode_step(self, codes: np.ndarray, state):
        """One streaming step: codes (C, t) or (B, C, t) -> (float32 PCM
        (B, t * spf) as numpy, new_state). Any t >= 1 is exact."""
        audio, state = self.decode_step_async(codes, state)
        return audio.float().cpu().numpy(), state

    @torch.inference_mode()
    def decode_step_async(self, codes, state):
        """decode_step without waiting for the card: host codes are copied
        behind the queued work (`host_to_device`), and the PCM (B, t * spf)
        stays a device tensor in the parameters' dtype."""
        codes = host_to_device(codes, self.device, torch.int64)
        if codes.dim() == 2:
            codes = codes[None]
        with _CODEC_LOCK:
            audio, state = firefly_decode_step(codes, self.params, self.cfg, state)
        return audio[:, 0, :], state

    @torch.inference_mode()
    def stream_template(self, batch: int) -> Dict:
        """The zero stream state for `batch` rows, made once per batch size
        and shared: steps return new state and never write it."""
        if batch not in self._stream_templates:
            self._stream_templates[batch] = stream_state_init(self.params, self.cfg, batch)
        return self._stream_templates[batch]


class FireflyStreamSession(StreamSessionBase):
    """Incremental Firefly decoder over one stream of `batch` rows:
    feed(codes (C, t)) returns the PCM of exactly those t frames."""

    def _template(self):
        return self.codec.stream_template(self.batch)
