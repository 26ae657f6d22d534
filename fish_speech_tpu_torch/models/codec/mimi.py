"""Mimi neural audio codec (Kyutai): 24 kHz audio <-> codes at 12.5 Hz,
the codec of generic DualAR (smoltts) checkpoints.

Counterpart of `fish_speech_tpu/models/codec/mimi.py`, with the JAX
package's parameter tree (torch layouts: conv (O, I/g, K), transposed
conv (I, O/g, K), linear (out, in)):

  encode: audio -> SEANet conv encoder -> causal transformer (RoPE,
          sliding window, layer scale) -> stride-2 downsample -> split
          residual VQ (1 semantic + N acoustic codebooks)
  decode: codes -> split-RVQ lookup -> stride-2 transposed upsample ->
          causal transformer -> SEANet conv decoder -> audio

No TPU kernel: every op is a convolution (cuDNN on the card), a matrix
product or an elementwise op. Every op of the decode path is causal, so
a streaming decode with carried state (conv tails, transposed-conv
overlap-add tails and a sliding-window KV ring) gives the batch decode of
the growing prefix.

Departures from JAX:
* `MimiCodec.decode` runs at the true length; the JAX codec pads to a
  compile bucket and trims, which the causal decode makes equal.
* The stream's KV ring keeps a position per batch row (`slot_pos` (B,
  ring), `pos` (B,)), so every leaf of the state is batched on axis 0 and
  the central vocoder can reset one lane or keep a lane that sat a tick
  out (`stream_conv.tree_where`). The JAX ring shares one position
  across rows, which a masked select over lanes cannot keep.

Weights: a transformers-format Mimi `model.safetensors` (kyutai/mimi),
read by the port's own safetensors reader (`load_mimi_params`), every
tensor's shape checked against the config (`mimi_state_shapes`).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fish_speech_tpu_torch.device import host_to_device, resolve_device, tree_to
from fish_speech_tpu_torch.models.codec.stream_conv import (
    _CODEC_LOCK, StreamSessionBase, _tf32, conv_state, conv_transpose_raw,
    conv_transpose_state, stream_conv1d, stream_conv_transpose1d)
from fish_speech_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class MimiConfig:
    """The transformers MimiConfig fields the codec needs; the defaults
    are kyutai/mimi's."""

    sampling_rate: int = 24000
    frame_rate: float = 12.5
    audio_channels: int = 1
    hidden_size: int = 512
    num_filters: int = 64
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    num_residual_layers: int = 1
    upsampling_ratios: Tuple[int, ...] = (8, 6, 5, 4)
    compress: int = 2
    trim_right_ratio: float = 1.0
    # transformer
    num_hidden_layers: int = 8
    num_attention_heads: int = 8
    num_key_value_heads: int = 8
    head_dim: int = 64
    intermediate_size: int = 2048
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: int = 250
    layer_scale_initial_scale: float = 0.01
    # quantizer
    num_quantizers: int = 32
    codebook_size: int = 2048
    codebook_dim: int = 256
    vector_quantization_hidden_dimension: int = 256
    num_semantic_quantizers: int = 1
    upsample_groups: int = 512

    @staticmethod
    def kyutai() -> "MimiConfig":
        """kyutai/mimi's config, which DualAR checkpoints are paired with."""
        return MimiConfig()

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.upsampling_ratios))

    @property
    def encodec_frame_rate(self) -> float:
        return self.sampling_rate / self.hop_length

    @property
    def has_resample(self) -> bool:
        return self.frame_rate != self.encodec_frame_rate


# --------------------------------------------------------------------------
# Causal convs (Encodec padding)
# --------------------------------------------------------------------------


def _extra_pad(length: int, k_eff: int, stride: int) -> int:
    """Right padding to the 'ideal length' (EncodecConv1d's rule)."""
    pad_total = k_eff - stride
    n_frames = (length - k_eff + pad_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + k_eff - pad_total
    return ideal - length


def mimi_conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int = 1,
                dilation: int = 1, groups: int = 1, pad_mode: str = "constant") -> torch.Tensor:
    """Causal conv: left pad k_eff - stride, right pad to the ideal
    length. x (B, C_in, T); w (C_out, C_in/groups, K)."""
    k_eff = (w.shape[-1] - 1) * dilation + 1
    pad_left = k_eff - stride
    pad_right = _extra_pad(x.shape[-1], k_eff, stride)
    if pad_left or pad_right:
        x = F.pad(x, (pad_left, pad_right), mode=pad_mode)
    return F.conv1d(x, w, b, stride=stride, dilation=dilation, groups=groups)


def mimi_conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                          stride: int, groups: int = 1,
                          trim_right_ratio: float = 1.0) -> torch.Tensor:
    """Causal transposed conv: the full transposed conv, then
    ceil((K - stride) * trim_right_ratio) trimmed from the right and the
    rest from the left. w (C_in, C_out/groups, K)."""
    out = conv_transpose_raw(x, w, stride=stride, groups=groups)
    if b is not None:
        out = out + b[None, :, None]
    pad_total = w.shape[-1] - stride
    pad_right = math.ceil(pad_total * trim_right_ratio)
    return out[..., pad_total - pad_right:out.shape[-1] - pad_right]


# --------------------------------------------------------------------------
# SEANet encoder / decoder
# --------------------------------------------------------------------------


def _resnet_block(x: torch.Tensor, p: Dict, dilation: int) -> torch.Tensor:
    """ELU -> conv(residual kernel, dilation) -> ELU -> conv(k=1), + skip."""
    h = mimi_conv1d(F.elu(x), p["block.1.w"], p.get("block.1.b"), dilation=dilation)
    return x + mimi_conv1d(F.elu(h), p["block.3.w"], p.get("block.3.b"))


def seanet_encode(x: torch.Tensor, params: Dict, cfg: MimiConfig) -> torch.Tensor:
    """(B, 1, T) audio -> (B, hidden, T / hop) latents."""
    layers = params["layers"]
    x = mimi_conv1d(x, layers[0]["w"], layers[0].get("b"))
    i = 1
    for ratio in reversed(cfg.upsampling_ratios):
        for j in range(cfg.num_residual_layers):
            x = _resnet_block(x, layers[i], cfg.dilation_growth_rate**j)
            i += 1
        x = mimi_conv1d(F.elu(x), layers[i]["w"], layers[i].get("b"), stride=ratio)
        i += 1
    return mimi_conv1d(F.elu(x), layers[i]["w"], layers[i].get("b"))


def seanet_decode(x: torch.Tensor, params: Dict, cfg: MimiConfig) -> torch.Tensor:
    """(B, hidden, F) latents -> (B, 1, F * hop) audio."""
    layers = params["layers"]
    x = mimi_conv1d(x, layers[0]["w"], layers[0].get("b"))
    i = 1
    for ratio in cfg.upsampling_ratios:
        x = mimi_conv_transpose1d(F.elu(x), layers[i]["w"], layers[i].get("b"), stride=ratio,
                                  trim_right_ratio=cfg.trim_right_ratio)
        i += 1
        for j in range(cfg.num_residual_layers):
            x = _resnet_block(x, layers[i], cfg.dilation_growth_rate**j)
            i += 1
    return mimi_conv1d(F.elu(x), layers[i]["w"], layers[i].get("b"))


# --------------------------------------------------------------------------
# Transformer (causal, RoPE rotate-half, sliding window, layer scale)
# --------------------------------------------------------------------------


def _rope_tables(pos: torch.Tensor, cfg: MimiConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of absolute positions `pos` (any shape) -> (..., hd)."""
    hd = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                                 device=pos.device) / hd))
    freqs = pos.to(torch.float32)[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate(q: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = q.shape[-1] // 2
    return q * cos + torch.cat([-q[..., half:], q[..., :half]], dim=-1) * sin


def _attend_and_mlp(x: torch.Tensor, lp: Dict, cfg: MimiConfig, q: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The rest of a layer from rotated q (B, h, t, hd) and keys/values
    (B, kvh, S, hd): attention under the additive float32 mask (B or 1,
    1, t, S), the output projection and the MLP, each scaled."""
    b, t, _ = x.shape
    h, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=1)
        v = v.repeat_interleave(h // kvh, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * (1.0 / math.sqrt(hd)) + mask
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", attn, v)
    o = o.transpose(1, 2).reshape(b, t, h * hd) @ lp["o.w"].T
    x = x + o * lp["ls_attn"]
    hin = layer_norm(x, lp["ln2.w"], lp["ln2.b"], cfg.norm_eps)
    mlp = F.gelu(hin @ lp["fc1.w"].T, approximate="none") @ lp["fc2.w"].T
    return x + mlp * lp["ls_mlp"]


def _qkv(x: torch.Tensor, lp: Dict, cfg: MimiConfig, cos, sin):
    """Rotated q (B, h, t, hd), rotated k and v (B, kvh, t, hd)."""
    b, t, _ = x.shape
    h, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    hin = layer_norm(x, lp["ln1.w"], lp["ln1.b"], cfg.norm_eps)
    q = (hin @ lp["q.w"].T).reshape(b, t, h, hd).transpose(1, 2)
    k = (hin @ lp["k.w"].T).reshape(b, t, kvh, hd).transpose(1, 2)
    v = (hin @ lp["v.w"].T).reshape(b, t, kvh, hd).transpose(1, 2)
    return _rotate(q, cos, sin), _rotate(k, cos, sin), v


def mimi_transformer(x: torch.Tensor, params: Dict, cfg: MimiConfig) -> torch.Tensor:
    """(B, T, D) -> (B, T, D), causal with a sliding attention window."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    cos, sin = _rope_tables(pos, cfg)
    q_pos, k_pos = pos[:, None], pos[None, :]
    allowed = (k_pos <= q_pos) & (q_pos - k_pos < cfg.sliding_window)
    mask = torch.where(allowed, 0.0, -1e9).to(torch.float32)[None, None]
    for lp in params["layers"]:
        q, k, v = _qkv(x, lp, cfg, cos, sin)
        x = _attend_and_mlp(x, lp, cfg, q, k, v, mask)
    return x


def transformer_stream_init(cfg: MimiConfig, batch: int, max_step: int = 64,
                            dtype=torch.float32, device="cpu") -> Dict:
    """The sliding-window KV ring, with sliding_window + max_step slots:
    with exactly `window` slots, a step of t > 1 positions would
    overwrite entries still inside the window of its earlier queries.
    Each row keeps its own slot positions and next position."""
    ring = cfg.sliding_window + max_step
    shape = (batch, cfg.num_key_value_heads, ring, cfg.head_dim)
    return {
        "layers": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)}
                   for _ in range(cfg.num_hidden_layers)],
        "slot_pos": torch.full((batch, ring), -1, dtype=torch.int64, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int64, device=device),
    }


def mimi_transformer_step(x: torch.Tensor, params: Dict, cfg: MimiConfig,
                          cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """(B, t, D) new positions against the ring; t must be at most the
    ring's max_step oversize. Returns (out, new cache); the cache given
    is not written."""
    b, t, _ = x.shape
    kvh, hd = cfg.num_key_value_heads, cfg.head_dim
    ring = cache["slot_pos"].shape[-1]
    q_abs = cache["pos"][:, None] + torch.arange(t, device=x.device)  # (B, t)
    slots = q_abs % ring
    cos, sin = _rope_tables(q_abs, cfg)
    cos, sin = cos[:, None], sin[:, None]  # (B, 1, t, hd)
    slot_pos = cache["slot_pos"].scatter(1, slots, q_abs)
    sp, qa = slot_pos[:, None, :], q_abs[:, :, None]
    valid = (sp >= 0) & (sp <= qa) & (qa - sp < cfg.sliding_window)
    mask = torch.where(valid, 0.0, -1e9).to(torch.float32)[:, None]  # (B, 1, t, ring)
    idx = slots[:, None, :, None].expand(b, kvh, t, hd)
    new_layers = []
    for lp, lc in zip(params["layers"], cache["layers"]):
        q, k, v = _qkv(x, lp, cfg, cos, sin)
        kc, vc = lc["k"].scatter(2, idx, k), lc["v"].scatter(2, idx, v)
        new_layers.append({"k": kc, "v": vc})
        x = _attend_and_mlp(x, lp, cfg, q, kc, vc, mask)
    return x, {"layers": new_layers, "slot_pos": slot_pos, "pos": cache["pos"] + t}


# --------------------------------------------------------------------------
# Split residual vector quantizer
# --------------------------------------------------------------------------


def _rvq_encode(emb: torch.Tensor, q: Dict, n: int) -> torch.Tensor:
    """emb (B, D_hid, T) -> codes (n, B, T) by residual nearest centroid."""
    if q.get("in_proj") is not None:
        emb = torch.einsum("oc,bct->bot", q["in_proj"], emb)
    residual = emb.transpose(1, 2)  # (B, T, D)
    codes = []
    for i in range(n):
        cb = q["codebooks"][i]  # (K, D)
        d = (torch.sum(residual**2, -1, keepdim=True) - 2.0 * residual @ cb.T
             + torch.sum(cb**2, -1))
        idx = torch.argmin(d, dim=-1)
        codes.append(idx)
        residual = residual - cb[idx]
    return torch.stack(codes)


def _rvq_decode(codes: torch.Tensor, q: Dict) -> torch.Tensor:
    """codes (B, n, T) -> (B, D_hidden, T)."""
    out = 0.0
    for i in range(codes.shape[1]):
        out = out + q["codebooks"][i][codes[:, i]]  # (B, T, D)
    out = out.transpose(1, 2)
    if q.get("out_proj") is not None:
        out = torch.einsum("oc,bct->bot", q["out_proj"], out)
    return out


def split_rvq_encode(emb: torch.Tensor, params: Dict, cfg: MimiConfig,
                     num_quantizers: Optional[int] = None) -> torch.Tensor:
    """(B, D, T) -> (B, K, T) codes: the semantic codebooks, then the
    acoustic ones, each RVQ starting from `emb`."""
    n = num_quantizers or cfg.num_quantizers
    ns = cfg.num_semantic_quantizers
    codes = _rvq_encode(emb, params["semantic"], ns)
    if n > ns:
        codes = torch.cat([codes, _rvq_encode(emb, params["acoustic"], n - ns)])
    return codes.transpose(0, 1)


def split_rvq_decode(codes: torch.Tensor, params: Dict, cfg: MimiConfig) -> torch.Tensor:
    ns = cfg.num_semantic_quantizers
    out = _rvq_decode(codes[:, :ns], params["semantic"])
    if codes.shape[1] > ns:
        out = out + _rvq_decode(codes[:, ns:], params["acoustic"])
    return out


# --------------------------------------------------------------------------
# The whole model
# --------------------------------------------------------------------------


def mimi_encode(audio: torch.Tensor, params: Dict, cfg: MimiConfig,
                num_quantizers: Optional[int] = None) -> torch.Tensor:
    """(B, 1, T) 24 kHz audio -> (B, K, frames) codes at frame_rate."""
    emb = seanet_encode(audio, params["encoder"], cfg)
    emb = mimi_transformer(emb.transpose(1, 2), params["encoder_transformer"],
                           cfg).transpose(1, 2)
    if cfg.has_resample:
        emb = mimi_conv1d(emb, params["downsample"]["w"], None, stride=2, pad_mode="replicate")
    return split_rvq_encode(emb, params["quantizer"], cfg, num_quantizers)


def mimi_decode(codes: torch.Tensor, params: Dict, cfg: MimiConfig) -> torch.Tensor:
    """(B, K, frames) codes -> (B, 1, T) 24 kHz audio."""
    emb = split_rvq_decode(codes, params["quantizer"], cfg)
    if cfg.has_resample:
        emb = mimi_conv_transpose1d(emb, params["upsample"]["w"], None, stride=2,
                                    groups=cfg.upsample_groups,
                                    trim_right_ratio=cfg.trim_right_ratio)
    emb = mimi_transformer(emb.transpose(1, 2), params["decoder_transformer"],
                           cfg).transpose(1, 2)
    return seanet_decode(emb, params["decoder"], cfg)


# --------------------------------------------------------------------------
# Streaming decode
# --------------------------------------------------------------------------


def _stream_resnet_block(x, p: Dict, dilation: int, state):
    h, s1 = stream_conv1d(F.elu(x), p["block.1.w"], p.get("block.1.b"), state[0],
                          dilation=dilation)
    h, s2 = stream_conv1d(F.elu(h), p["block.3.w"], p.get("block.3.b"), state[1])
    return x + h, (s1, s2)


def seanet_decode_stream_init(params: Dict, cfg: MimiConfig, batch: int) -> List:
    """Zero carried state of `seanet_decode_stream`, in layer order."""
    layers = params["layers"]

    def cs(w, dilation=1):
        return conv_state(batch, w.shape[1], w.shape[-1], dilation=dilation, dtype=w.dtype,
                          device=w.device)

    states = [cs(layers[0]["w"])]
    i = 1
    for ratio in cfg.upsampling_ratios:
        w = layers[i]["w"]  # (C_in, C_out, K)
        states.append(conv_transpose_state(batch, w.shape[1], w.shape[-1], stride=ratio,
                                           dtype=w.dtype, device=w.device))
        i += 1
        for j in range(cfg.num_residual_layers):
            lp = layers[i]
            states.append((cs(lp["block.1.w"], cfg.dilation_growth_rate**j),
                           cs(lp["block.3.w"])))
            i += 1
    states.append(cs(layers[i]["w"]))
    return states


def seanet_decode_stream(x: torch.Tensor, params: Dict, cfg: MimiConfig, states: List):
    """Streaming twin of seanet_decode: the same layer walk with carried
    state. Returns (audio, new states)."""
    layers = params["layers"]
    x, s = stream_conv1d(x, layers[0]["w"], layers[0].get("b"), states[0])
    new_states = [s]
    i = 1
    for ratio in cfg.upsampling_ratios:
        x, s = stream_conv_transpose1d(F.elu(x), layers[i]["w"], layers[i].get("b"), states[i],
                                       stride=ratio)
        new_states.append(s)
        i += 1
        for j in range(cfg.num_residual_layers):
            x, s = _stream_resnet_block(x, layers[i], cfg.dilation_growth_rate**j, states[i])
            new_states.append(s)
            i += 1
    x, s = stream_conv1d(F.elu(x), layers[i]["w"], layers[i].get("b"), states[i])
    new_states.append(s)
    return x, new_states


def mimi_decode_stream_init(params: Dict, cfg: MimiConfig, batch: int = 1,
                            max_step: int = 64) -> Dict:
    """max_step: the most transformer positions (2 a code frame with
    has_resample) one decode step may feed."""
    ref = params["decoder"]["layers"][0]["w"]
    state = {
        "transformer": transformer_stream_init(cfg, batch, max_step, ref.dtype, ref.device),
        "seanet": seanet_decode_stream_init(params["decoder"], cfg, batch),
    }
    if cfg.has_resample:
        w = params["upsample"]["w"]  # (C_in, C_out/groups, K), groups = C_in
        state["upsample"] = conv_transpose_state(batch, cfg.upsample_groups * w.shape[1],
                                                 w.shape[-1], stride=2, dtype=w.dtype,
                                                 device=w.device)
    return state


def mimi_decode_step(codes: torch.Tensor, params: Dict, cfg: MimiConfig,
                     state: Dict) -> Tuple[torch.Tensor, Dict]:
    """Streaming twin of mimi_decode: (B, K, t) codes -> ((B, 1, t * spf)
    PCM, new state). Chunks of any sizes give the prefix concatenation of
    the batch decode."""
    emb = split_rvq_decode(codes, params["quantizer"], cfg)
    new_state = dict(state)
    if cfg.has_resample:
        emb, new_state["upsample"] = stream_conv_transpose1d(
            emb, params["upsample"]["w"], None, state["upsample"], stride=2,
            groups=cfg.upsample_groups)
    emb, new_state["transformer"] = mimi_transformer_step(
        emb.transpose(1, 2), params["decoder_transformer"], cfg, state["transformer"])
    audio, new_state["seanet"] = seanet_decode_stream(emb.transpose(1, 2), params["decoder"],
                                                      cfg, state["seanet"])
    return audio, new_state


# --------------------------------------------------------------------------
# Weights: transformers' MimiModel state dict
# --------------------------------------------------------------------------


def _seanet_convs(cfg: MimiConfig, decoder: bool) -> List[Tuple[int, str, tuple]]:
    """(layer index, kind, weight shape) of the weighted SEANet layers,
    kind "conv", "tconv" or "res" (whose shape is its first conv's);
    ELUs are layers without weights."""
    nf, r = cfg.num_filters, cfg.num_residual_layers
    n = len(cfg.upsampling_ratios)
    out, i = [], 0
    if not decoder:
        out.append((0, "conv", (nf, cfg.audio_channels, cfg.kernel_size)))
        i = 1
        for s, ratio in enumerate(reversed(cfg.upsampling_ratios)):
            ch = nf * 2**s
            for _ in range(r):
                out.append((i, "res", (ch // cfg.compress, ch, cfg.residual_kernel_size)))
                i += 1
            out.append((i + 1, "conv", (ch * 2, ch, ratio * 2)))
            i += 2
        out.append((i + 1, "conv", (cfg.hidden_size, nf * 2**n, cfg.last_kernel_size)))
        return out
    out.append((0, "conv", (nf * 2**n, cfg.hidden_size, cfg.kernel_size)))
    i = 1
    for s, ratio in enumerate(cfg.upsampling_ratios):
        ch = nf * 2 ** (n - s)
        out.append((i + 1, "tconv", (ch, ch // 2, ratio * 2)))
        i += 2
        for _ in range(r):
            out.append((i, "res", (ch // 2 // cfg.compress, ch // 2, cfg.residual_kernel_size)))
            i += 1
    out.append((i + 1, "conv", (cfg.audio_channels, nf, cfg.last_kernel_size)))
    return out


def mimi_state_shapes(cfg: MimiConfig) -> Dict[str, tuple]:
    """{transformers state-dict name: shape} of a Mimi model with this
    config (`num_quantizers` codebooks); the tensors the loader reads."""
    shapes: Dict[str, tuple] = {}
    for part in ("encoder", "decoder"):
        for i, kind, shape in _seanet_convs(cfg, part == "decoder"):
            base = f"{part}.layers.{i}"
            if kind == "res":
                c_half, c = shape[0], shape[1]
                shapes[f"{base}.block.1.conv.weight"] = shape
                shapes[f"{base}.block.1.conv.bias"] = (c_half,)
                shapes[f"{base}.block.3.conv.weight"] = (c, c_half, 1)
                shapes[f"{base}.block.3.conv.bias"] = (c,)
            else:
                shapes[f"{base}.conv.weight"] = shape
                shapes[f"{base}.conv.bias"] = (shape[1] if kind == "tconv" else shape[0],)
    d, hd = cfg.hidden_size, cfg.head_dim
    for part in ("encoder_transformer", "decoder_transformer"):
        for i in range(cfg.num_hidden_layers):
            b = f"{part}.layers.{i}"
            shapes.update({
                f"{b}.self_attn.q_proj.weight": (cfg.num_attention_heads * hd, d),
                f"{b}.self_attn.k_proj.weight": (cfg.num_key_value_heads * hd, d),
                f"{b}.self_attn.v_proj.weight": (cfg.num_key_value_heads * hd, d),
                f"{b}.self_attn.o_proj.weight": (d, cfg.num_attention_heads * hd),
                f"{b}.mlp.fc1.weight": (cfg.intermediate_size, d),
                f"{b}.mlp.fc2.weight": (d, cfg.intermediate_size),
                f"{b}.input_layernorm.weight": (d,),
                f"{b}.input_layernorm.bias": (d,),
                f"{b}.post_attention_layernorm.weight": (d,),
                f"{b}.post_attention_layernorm.bias": (d,),
                f"{b}.self_attn_layer_scale.scale": (d,),
                f"{b}.mlp_layer_scale.scale": (d,),
            })
    if cfg.has_resample:
        shapes["downsample.conv.weight"] = (d, d, 4)
        shapes["upsample.conv.weight"] = (d, d // cfg.upsample_groups, 4)
    ns = cfg.num_semantic_quantizers
    for name, n in (("semantic", ns), ("acoustic", cfg.num_quantizers - ns)):
        prefix = f"quantizer.{name}_residual_vector_quantizer"
        for i in range(n):
            shapes[f"{prefix}.layers.{i}.codebook.embed_sum"] = (cfg.codebook_size,
                                                                 cfg.codebook_dim)
            shapes[f"{prefix}.layers.{i}.codebook.cluster_usage"] = (cfg.codebook_size,)
        if cfg.vector_quantization_hidden_dimension != d:
            vq = cfg.vector_quantization_hidden_dimension
            shapes[f"{prefix}.input_proj.weight"] = (vq, d, 1)
            shapes[f"{prefix}.output_proj.weight"] = (d, vq, 1)
    return shapes


def convert_mimi_state_dict(sd: Dict, cfg: MimiConfig, dtype=torch.float32,
                            device="cpu") -> Dict:
    """A transformers MimiModel state dict ({name: tensor or array}) ->
    the parameter tree on `device`, every tensor's shape checked
    (`mimi_state_shapes`). Codebooks are embed_sum / max(usage, 1e-5) in
    float64, then cast, as JAX computes them."""
    shapes = mimi_state_shapes(cfg)

    def raw(name: str) -> torch.Tensor:
        if name not in sd:
            raise KeyError(f"Missing Mimi weight {name!r}")
        t = torch.as_tensor(sd[name])
        if tuple(t.shape) != tuple(shapes[name]):
            raise ValueError(f"Mimi weight {name!r} has shape {tuple(t.shape)}, the config "
                             f"expects {tuple(shapes[name])}")
        return t.to(device)

    def get(name: str) -> torch.Tensor:
        return raw(name).to(dtype)

    def seanet(part: str) -> Dict:
        layers = []
        for i, kind, _ in _seanet_convs(cfg, part == "decoder"):
            base = f"{part}.layers.{i}"
            if kind == "res":
                layers.append({"block.1.w": get(f"{base}.block.1.conv.weight"),
                               "block.1.b": get(f"{base}.block.1.conv.bias"),
                               "block.3.w": get(f"{base}.block.3.conv.weight"),
                               "block.3.b": get(f"{base}.block.3.conv.bias")})
            else:
                layers.append({"w": get(f"{base}.conv.weight"), "b": get(f"{base}.conv.bias")})
        return {"layers": layers}

    def transformer(part: str) -> Dict:
        names = {"q.w": "self_attn.q_proj.weight", "k.w": "self_attn.k_proj.weight",
                 "v.w": "self_attn.v_proj.weight", "o.w": "self_attn.o_proj.weight",
                 "fc1.w": "mlp.fc1.weight", "fc2.w": "mlp.fc2.weight",
                 "ln1.w": "input_layernorm.weight", "ln1.b": "input_layernorm.bias",
                 "ln2.w": "post_attention_layernorm.weight",
                 "ln2.b": "post_attention_layernorm.bias",
                 "ls_attn": "self_attn_layer_scale.scale", "ls_mlp": "mlp_layer_scale.scale"}
        return {"layers": [{k: get(f"{part}.layers.{i}.{v}") for k, v in names.items()}
                           for i in range(cfg.num_hidden_layers)]}

    def rvq(name: str, n: int) -> Dict:
        prefix = f"quantizer.{name}_residual_vector_quantizer"
        books = []
        for i in range(n):
            b = f"{prefix}.layers.{i}.codebook"
            usage = raw(f"{b}.cluster_usage").double().clamp(min=1e-5)
            books.append((raw(f"{b}.embed_sum").double() / usage[:, None]).to(dtype))
        out = {"codebooks": books}
        if f"{prefix}.input_proj.weight" in shapes:
            out["in_proj"] = get(f"{prefix}.input_proj.weight")[:, :, 0]
            out["out_proj"] = get(f"{prefix}.output_proj.weight")[:, :, 0]
        return out

    ns = cfg.num_semantic_quantizers
    params = {
        "encoder": seanet("encoder"),
        "decoder": seanet("decoder"),
        "encoder_transformer": transformer("encoder_transformer"),
        "decoder_transformer": transformer("decoder_transformer"),
        "quantizer": {"semantic": rvq("semantic", ns),
                      "acoustic": rvq("acoustic", cfg.num_quantizers - ns)},
    }
    if cfg.has_resample:
        params["downsample"] = {"w": get("downsample.conv.weight")}
        params["upsample"] = {"w": get("upsample.conv.weight")}
    return params


def load_mimi_params(path: str | Path, cfg: MimiConfig, dtype=torch.float32,
                     device="cuda") -> Dict:
    """Mimi weights from a transformers-format safetensors file (kyutai/
    mimi's model.safetensors) onto `device`. The moshi-MLX export the
    upstream server reads has other names: re-export it through
    transformers."""
    from fish_speech_tpu_torch.io.checkpoint import _read_safetensors

    device = resolve_device(device)
    sd = _read_safetensors(Path(path))
    if "encoder.layers.0.conv.weight" not in sd:
        raise ValueError(f"{path} does not look like a transformers-format Mimi checkpoint "
                         "(expected encoder.layers.N.conv.weight names)")
    return convert_mimi_state_dict(sd, cfg, dtype, device)


def random_mimi_state_dict(cfg: MimiConfig, seed: int = 2,
                           device="cuda") -> Dict[str, torch.Tensor]:
    """Random float32 weights in the transformers names, from a seed, for
    runs without a checkpoint: convs and linears N(0, 1 / fan_in), zero
    biases, unit norms, layer scales at layer_scale_initial_scale,
    codebook sums N(0, 1) over usages in [0.5, 2)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    # a transposed conv's output sample sums K / stride = 2 taps of each
    # input channel of its group
    tconv_in = {f"decoder.layers.{i}.conv.weight": shape[0]
                for i, kind, shape in _seanet_convs(cfg, True) if kind == "tconv"}
    tconv_in["upsample.conv.weight"] = cfg.hidden_size // cfg.upsample_groups
    sd = {}
    for name, shape in mimi_state_shapes(cfg).items():
        if name.endswith("cluster_usage"):
            t = torch.rand(shape, generator=gen, device=device) * 1.5 + 0.5
        elif name.endswith("embed_sum"):
            t = torch.randn(shape, generator=gen, device=device)
        elif name.endswith(".scale"):
            t = torch.full(shape, cfg.layer_scale_initial_scale, device=device)
        elif "layernorm" in name:
            t = (torch.ones if name.endswith("weight") else torch.zeros)(shape, device=device)
        elif name.endswith("bias"):
            t = torch.zeros(shape, device=device)
        else:
            fan_in = 2 * tconv_in[name] if name in tconv_in else int(np.prod(shape[1:]))
            t = torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)
        sd[name] = t
    return sd


# --------------------------------------------------------------------------
# The codec
# --------------------------------------------------------------------------


class MimiCodec:
    """User-facing codec with FireflyCodec's interface: codes (K, T) or
    (B, K, T) -> float32 PCM at 24 kHz, audio -> codes, and carried-state
    streaming. num_quantizers: the codebooks an encode gives (the LM's
    codebook count); a decode takes as many as the codes have."""

    def __init__(self, params: Dict, cfg: MimiConfig, num_quantizers: Optional[int] = None, *,
                 device="cuda") -> None:
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg
        self.sample_rate = cfg.sampling_rate
        self.num_quantizers = num_quantizers or cfg.num_quantizers
        self._stream_templates: Dict[Tuple[int, int], Dict] = {}

    @property
    def samples_per_frame(self) -> int:
        """1920 at 24 kHz and 12.5 Hz."""
        return int(round(self.sample_rate / self.cfg.frame_rate))

    @torch.inference_mode()
    def decode(self, codes: np.ndarray) -> np.ndarray:
        """codes (K, T) or (B, K, T) -> (B, T * spf) float32 PCM."""
        codes = np.asarray(codes)
        if codes.ndim == 2:
            codes = codes[None]
        codes = torch.from_numpy(codes.astype(np.int64)).to(self.device)
        with _CODEC_LOCK:
            audio = mimi_decode(codes, self.params, self.cfg)[:, 0, :]
        return audio.float().cpu().numpy()

    @torch.inference_mode()
    def encode(self, audio) -> np.ndarray:
        """audio (T,) or (B, T) at 24 kHz -> (B, num_quantizers, frames)
        int32 codes, with TF32 off on the card (it moves codes near a tie
        between centroids)."""
        audio = np.atleast_2d(np.asarray(audio, dtype=np.float32))[:, None, :]
        dtype = self.params["encoder"]["layers"][0]["w"].dtype
        x = torch.from_numpy(audio).to(self.device, dtype)
        with _tf32(False):
            codes = mimi_encode(x, self.params, self.cfg, self.num_quantizers)
        return codes.to(torch.int32).cpu().numpy()

    # -- streaming ----------------------------------------------------------

    @property
    def can_stream(self) -> bool:
        """Every op of the decode path is causal."""
        return True

    def start_stream(self, batch: int = 1, max_step_frames: int = 32) -> "MimiStreamSession":
        """A carried-state decode session: feed code frames as they come and
        receive the PCM the batch decode gives for the growing prefix
        (the upstream server's decode_step; a new session is its
        reset_state)."""
        return MimiStreamSession(self, batch, max_step_frames)

    def decode_step(self, codes: np.ndarray, state):
        """One streaming step: codes (K, t) or (B, K, t) -> (float32 PCM
        (B, t * spf) as numpy, new_state)."""
        audio, state = self.decode_step_async(codes, state)
        return audio.float().cpu().numpy(), state

    @torch.inference_mode()
    def decode_step_async(self, codes, state):
        """decode_step without waiting for the card: the PCM stays a device
        tensor in the parameters' dtype. Refuses a step of more
        transformer positions (2 a frame with has_resample) than the
        state's ring oversize: it would recycle slots still inside its
        earlier queries' windows."""
        codes = host_to_device(codes, self.device, torch.int64)
        if codes.dim() == 2:
            codes = codes[None]
        t = codes.shape[-1]
        tsteps = t * (2 if self.cfg.has_resample else 1)
        ring = state["transformer"]["slot_pos"].shape[-1]
        max_step = ring - self.cfg.sliding_window
        if tsteps > max_step:
            raise ValueError(
                f"decode_step fed {t} code frames = {tsteps} transformer positions, but this "
                f"stream state takes at most {max_step} a call (ring {ring} - window "
                f"{self.cfg.sliding_window}); start the stream with a larger max_step_frames "
                f"or feed smaller chunks")
        with _CODEC_LOCK:
            audio, state = mimi_decode_step(codes, self.params, self.cfg, state)
        return audio[:, 0, :], state

    @torch.inference_mode()
    def stream_template(self, batch: int, max_step_frames: int) -> Dict:
        """The zero stream state for `batch` rows and steps of up to
        `max_step_frames` frames, made once and shared: steps return new
        state and never write it."""
        key = (batch, max_step_frames)
        if key not in self._stream_templates:
            tsteps = max_step_frames * (2 if self.cfg.has_resample else 1)
            self._stream_templates[key] = mimi_decode_stream_init(self.params, self.cfg,
                                                                  batch, max_step=tsteps)
        return self._stream_templates[key]


class MimiStreamSession(StreamSessionBase):
    """Incremental Mimi decoder over one stream of `batch` rows:
    feed(codes (K, t)) returns the PCM of exactly those t frames."""

    def _template(self):
        return self.codec.stream_template(self.batch, self.max_step)
