"""Carried-state streaming decode of the Firefly codec (Fish 1.4+).

Counterpart of `fish_speech_tpu/models/codec/firefly_stream.py`. The
Fish 1.4+ decode path is causal (its convs left-pad, its transposed
convs right-trim), so a chunked decode with a carried state per conv
gives the batch `firefly_decode` output of the growing prefix, each
frame decoded once. Fish 1.2 pads symmetrically, which is not causal:
`stream_state_init` refuses it.

The state is a nested dict/list of zero conv tails on the parameters'
device, batched on axis 0:
  {"quantizer": [per upsample stage: {"up": tail, "block": dwconv tail}],
   "head": {"pre": tail,
            "stages": [{"up": tail, "resblocks": [[(s1, s2) per dilation]
                                                  per kernel]}],
            "post": tail}}
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from fish_speech_tpu_torch.config import FireflyConfig, FishVersion
from fish_speech_tpu_torch.models.codec import grfsq
from fish_speech_tpu_torch.models.codec.hifigan import _silu
from fish_speech_tpu_torch.models.codec.stream_conv import (
    conv_state, conv_transpose_state, stream_conv1d, stream_conv_transpose1d)
from fish_speech_tpu_torch.ops.norms import layer_norm


def _stream_convnext_block(x: torch.Tensor, p: Dict,
                           state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming twin of convnext_block (dilation 1, the kernel size of
    the dwconv weight): only the depthwise conv is time-coupled."""
    h, new_state = stream_conv1d(x, p["dwconv"]["w"], p["dwconv"]["b"], state,
                                 groups=x.shape[1])
    h = h.transpose(1, 2)
    h = layer_norm(h, p["norm"]["w"], p["norm"]["b"], 1e-6)
    h = h @ p["pwconv1"]["w"] + p["pwconv1"]["b"]
    h = F.gelu(h.float(), approximate="none").to(h.dtype)
    h = h @ p["pwconv2"]["w"] + p["pwconv2"]["b"]
    if p.get("gamma") is not None:
        h = p["gamma"] * h
    return x + h.transpose(1, 2), new_state


def _stream_resblock1(x: torch.Tensor, p: Dict, dilations,
                      states) -> Tuple[torch.Tensor, List]:
    """Streaming ResBlock1, 1.4+ semantics: convs2 runs convs1's dilation."""
    new_states = []
    for i, d in enumerate(dilations):
        xt, s1 = stream_conv1d(_silu(x), p["convs1"][i]["w"], p["convs1"][i]["b"],
                               states[i][0], dilation=d)
        xt, s2 = stream_conv1d(_silu(xt), p["convs2"][i]["w"], p["convs2"][i]["b"],
                               states[i][1], dilation=d)
        x = x + xt
        new_states.append((s1, s2))
    return x, new_states


def stream_state_init(params: Dict, cfg: FireflyConfig, batch: int = 1) -> Dict:
    """Zero carried state of `firefly_decode_step`, in the parameters'
    dtype and on their device."""
    if cfg.version == FishVersion.V1_2:
        raise ValueError("Fish 1.2 convs pad symmetrically (not causal); streaming decode "
                         "needs Fish 1.4+")

    def cs(w, *, dilation=1, groups=1):
        return conv_state(batch, w.shape[1] * groups, w.shape[-1], dilation=dilation,
                          dtype=w.dtype, device=w.device)

    def cts(w, stride):  # w (I, O, K)
        return conv_transpose_state(batch, w.shape[1], w.shape[-1], stride=stride,
                                    dtype=w.dtype, device=w.device)

    q_states = []
    for i, layer in enumerate(params["quantizer"]["upsample"]):
        dw = layer["block"]["dwconv"]["w"]  # depthwise (dim, 1, k)
        q_states.append({"up": cts(layer["conv"]["w"], cfg.quantizer.downsample_factor[i]),
                         "block": cs(dw, groups=dw.shape[0])})
    head, hcfg = params["head"], cfg.head
    stages = []
    for i, u in enumerate(hcfg.upsample_rates):
        resblocks = []
        for j, rd in enumerate(hcfg.resblock_dilation_sizes):
            p = head["resblocks"][i][j]
            resblocks.append([(cs(p["convs1"][t]["w"], dilation=d),
                               cs(p["convs2"][t]["w"], dilation=d)) for t, d in enumerate(rd)])
        stages.append({"up": cts(head["ups"][i]["w"], u), "resblocks": resblocks})
    return {"quantizer": q_states,
            "head": {"pre": cs(head["conv_pre"]["w"]), "stages": stages,
                     "post": cs(head["conv_post"]["w"])}}


def firefly_decode_step(indices: torch.Tensor, params: Dict, cfg: FireflyConfig,
                        state: Dict) -> Tuple[torch.Tensor, Dict]:
    """Streaming twin of firefly_decode: (B, num_codebooks, t) codes ->
    ((B, 1, t * ds * hop) PCM, new_state). Chunks of any sizes give the
    prefix concatenation of the batch decode."""
    b, _, t = indices.shape
    qcfg = cfg.quantizer
    grouped = indices.reshape(b, qcfg.n_groups, qcfg.n_codebooks, t).permute(1, 0, 3, 2)
    z = grfsq.grouped_decode(grouped, params["quantizer"]["rvqs"], qcfg)  # (B, t, dim)
    z = z.transpose(1, 2).to(params["quantizer"]["upsample"][0]["conv"]["w"].dtype)

    new_q = []
    for i, layer in enumerate(params["quantizer"]["upsample"]):
        qs = state["quantizer"][i]
        z, s_up = stream_conv_transpose1d(z, layer["conv"]["w"], layer["conv"]["b"], qs["up"],
                                          stride=qcfg.downsample_factor[i])
        z, s_blk = _stream_convnext_block(z, layer["block"], qs["block"])
        new_q.append({"up": s_up, "block": s_blk})

    head, hcfg, hstate = params["head"], cfg.head, state["head"]
    h, s_pre = stream_conv1d(z, head["conv_pre"]["w"], head["conv_pre"]["b"], hstate["pre"])
    new_stages = []
    for i, u in enumerate(hcfg.upsample_rates):
        st = hstate["stages"][i]
        h, s_up = stream_conv_transpose1d(_silu(h), head["ups"][i]["w"], head["ups"][i]["b"],
                                          st["up"], stride=u)
        acc, new_rb = None, []
        for j, rd in enumerate(hcfg.resblock_dilation_sizes):
            out, s_rb = _stream_resblock1(h, head["resblocks"][i][j], rd, st["resblocks"][j])
            acc = out if acc is None else acc + out
            new_rb.append(s_rb)
        h = acc / len(hcfg.resblock_kernel_sizes)
        new_stages.append({"up": s_up, "resblocks": new_rb})
    h, s_post = stream_conv1d(_silu(h), head["conv_post"]["w"], head["conv_post"]["b"],
                              hstate["post"])
    audio = torch.tanh(h.float()).to(h.dtype)
    return audio, {"quantizer": new_q,
                   "head": {"pre": s_pre, "stages": new_stages, "post": s_post}}
