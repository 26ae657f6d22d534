"""Checkpoint IO: Fish Speech safetensors / torch .pth files in the
upstream key names <-> the port's parameter trees.

Counterpart of `fish_speech_tpu/io/checkpoint.py`, with the same trees:

* LM: `embeddings` / `codebook_embeddings` / `fast_embeddings`, per layer
  `{layers,fast_layers}.N.{attention.{wqkv,wo},feed_forward.{w1,w2,w3},
  attention_norm,ffn_norm}.weight`, `norm` / `fast_norm` / `output` /
  `fast_output`. Linear weights are transposed to (in, out) and layers
  stacked to (L, ...); `wqkv` stays fused.
* Codec: the ConvNeXt backbone, `quantizer.{downsample,upsample}.N.{0,1}`,
  `quantizer.residual_fsq.rvqs.N.{project_in,project_out}` and the
  HiFiGAN head. Fish 1.4+ wraps every Fish conv in a `conv.` infix;
  Fish 1.2 .pth files carry weight-norm parametrizations, merged at read
  as w = g * v / ||v|| in float64 over every dimension but 0, then
  rounded to float32.

Reading needs neither the `safetensors` package nor `ml_dtypes`, and
gives what the JAX reader gives: the safetensors header (an 8-byte
little-endian length, then JSON) is parsed here and each tensor viewed
in a private (copy-on-write) map of the file in its stored dtype, bf16
bit for bit (a file holding F8_E4M3 / F8_E5M2 tensors has every float
widened to float32); .pth files go through
`torch.load(weights_only=True)`, floats widened to float32. The loaders
move each tensor to the device as read, in its stored dtype, cast,
transpose and stack it there, and check every tensor's shape against
the config (the JAX loaders do not). The writers are the loaders'
inverses (the safetensors header padded to 8 bytes, as the format
allows).
"""

from __future__ import annotations

import json
import mmap
from pathlib import Path
from typing import Dict, Sequence

import torch

from fish_speech_tpu_torch.config import DualARConfig, FireflyConfig, FishVersion
from fish_speech_tpu_torch.device import resolve_device

_SAFETENSORS_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "U16": torch.uint16,
    "U32": torch.uint32,
    "U64": torch.uint64,
    "BOOL": torch.bool,
}
# stored in 8 bits, widened to float32 at read
_WIDENED_DTYPES = {"F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2}

LM_FILES = ("model.safetensors", "model.pth", "pytorch_model.bin")
FIREFLY_FILES = (
    "firefly-gan-vq-fsq-8x1024-21hz-generator.safetensors",
    "firefly-gan-vq-fsq-4x1024-42hz-generator.safetensors",
    "firefly-gan-vq-fsq-4x1024-42hz-generator-merged.pth",
    "firefly-gan-base-generator.ckpt",
)

_G = "parametrizations.weight.original0"
_V = "parametrizations.weight.original1"


def _read_safetensors(path: Path) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} in the stored dtypes; a file holding F8 tensors
    has every float widened to float32 (what the JAX package's fallback
    through the safetensors package gives)."""
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(header_len))
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + header_len
    out: Dict[str, torch.Tensor] = {}
    widen = False
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        code = meta["dtype"]
        dt = _SAFETENSORS_DTYPES.get(code, _WIDENED_DTYPES.get(code))
        if dt is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {code}, which the reader "
                             "does not map")
        widen |= code in _WIDENED_DTYPES
        begin, end = meta["data_offsets"]
        count = (end - begin) // dt.itemsize
        offset = base + begin
        if count == 0:
            t = torch.empty(meta["shape"], dtype=dt)
        elif offset % dt.itemsize:  # a writer that did not align: copy this range once
            t = torch.frombuffer(bytearray(mm[offset:base + end]), dtype=dt, count=count)
        else:
            t = torch.frombuffer(mm, dtype=dt, count=count, offset=offset)
        out[name] = t.reshape(meta["shape"])
    return _widened(out) if widen else out


def _widened(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: (v.float() if v.is_floating_point() else v) for k, v in state.items()}


def _unwrap_state_dict(state):
    if isinstance(state, dict) and "state_dict" in state:
        return state["state_dict"]
    return state


def _merge_weight_norm(raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold torch weight_norm parametrizations into `weight`:
    g * v / ||v||, the norm over every dimension but 0, in float64,
    rounded to float32."""
    out: Dict[str, torch.Tensor] = {}
    for name, val in raw.items():
        if name.endswith(_G):
            base = name[: -len(_G)]
            g = val.double()
            v = raw[base + _V].double()
            norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))
            out[base + "weight"] = (g * v / norm).float()
        elif "parametrizations" not in name:
            out[name] = val
    return out


def _read_torch_pickle(path: Path) -> Dict[str, torch.Tensor]:
    """Zip (torch >= 1.6) and legacy pickles alike: the tensors, floats
    widened to float32, weight norm merged."""
    state = _unwrap_state_dict(torch.load(str(path), map_location="cpu", weights_only=True))
    return _merge_weight_norm(_widened(
        {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}))


def load_raw_checkpoint(path: str | Path) -> Dict[str, torch.Tensor]:
    """One weights file as {name: CPU tensor}, as the JAX package reads
    it: safetensors in the stored dtypes (bf16 bit for bit), torch
    pickles with floats widened to float32 and weight norm merged."""
    path = Path(path)
    return _read_safetensors(path) if path.suffix == ".safetensors" else _read_torch_pickle(path)


def _find_weights_file(ckpt_dir: Path, names: Sequence[str]) -> Path:
    for name in names:
        p = ckpt_dir / name
        if p.exists():
            return p
    raise FileNotFoundError(f"No weights file in {ckpt_dir} (tried {list(names)})")


class _Reader:
    """Reads a file's tensors by name onto a device, checking shapes."""

    def __init__(self, path: Path, dtype, device) -> None:
        self.path = path
        self.raw = load_raw_checkpoint(path)
        self.dtype = dtype
        self.device = device

    def has(self, name: str) -> bool:
        return name in self.raw

    def get(self, name: str, shape) -> torch.Tensor:
        """The tensor on the device in the loader's dtype; moved in its
        stored dtype, cast there."""
        if name not in self.raw:
            raise KeyError(f"Missing weight {name!r} in {self.path}")
        t = self.raw[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{self.path}: {name!r} has shape {tuple(t.shape)}, the config "
                             f"expects {tuple(shape)}")
        return t.to(self.device).to(self.dtype)

    def linear_t(self, name: str, n_in: int, n_out: int) -> torch.Tensor:
        """A torch (out, in) linear weight as (in, out)."""
        return self.get(name, (n_out, n_in)).T.contiguous()


# --------------------------------------------------------------------------
# LM
# --------------------------------------------------------------------------


def load_lm_params(checkpoint: str | Path, cfg: DualARConfig, dtype=torch.bfloat16,
                   device="cuda") -> Dict:
    """checkpoint: a directory holding model.safetensors / model.pth, or a
    weights file. Returns the DualAR parameter tree on `device`."""
    device = resolve_device(device)
    if cfg.attention_qkv_bias:
        raise ValueError("attention_qkv_bias=True: the model has no qkv bias")
    path = Path(checkpoint)
    if path.is_dir():
        path = _find_weights_file(path, LM_FILES)
    r = _Reader(path, dtype, device)
    d, f = cfg.dim, cfg.ffn_dim
    qkv = (cfg.n_head + 2 * cfg.n_local_heads) * cfg.head_dim
    attn = cfg.n_head * cfg.head_dim

    def stack(prefix: str, n: int) -> Dict[str, torch.Tensor]:
        def each(fn):
            return torch.stack([fn(f"{prefix}.{i}") for i in range(n)])

        return {
            "wqkv": each(lambda p: r.linear_t(f"{p}.attention.wqkv.weight", d, qkv)),
            "wo": each(lambda p: r.linear_t(f"{p}.attention.wo.weight", attn, d)),
            "w1": each(lambda p: r.linear_t(f"{p}.feed_forward.w1.weight", d, f)),
            "w3": each(lambda p: r.linear_t(f"{p}.feed_forward.w3.weight", d, f)),
            "w2": each(lambda p: r.linear_t(f"{p}.feed_forward.w2.weight", f, d)),
            "attention_norm": each(lambda p: r.get(f"{p}.attention_norm.weight", (d,))),
            "ffn_norm": each(lambda p: r.get(f"{p}.ffn_norm.weight", (d,))),
        }

    embeddings = r.get("embeddings.weight", (cfg.vocab_size, d))
    output = (embeddings.T.contiguous() if cfg.tie_word_embeddings
              else r.linear_t("output.weight", d, cfg.vocab_size))
    return {
        "embeddings": embeddings,
        "codebook_embeddings": r.get("codebook_embeddings.weight",
                                     (cfg.codebook_size * cfg.num_codebooks, d)),
        "fast_embeddings": r.get("fast_embeddings.weight", (cfg.fast_vocab_size, d)),
        "norm": r.get("norm.weight", (d,)),
        "fast_norm": r.get("fast_norm.weight", (d,)),
        "output": output,
        "fast_output": r.linear_t("fast_output.weight", d, cfg.fast_output_size),
        "slow": stack("layers", cfg.n_layer),
        "fast": stack("fast_layers", cfg.n_fast_layer),
    }


# --------------------------------------------------------------------------
# Firefly codec
# --------------------------------------------------------------------------


def load_firefly_params(checkpoint: str | Path, cfg: FireflyConfig, dtype=torch.float32,
                        device="cuda") -> Dict:
    """checkpoint: a Firefly weights file (safetensors or merged/raw
    .pth), or a directory holding one under its upstream name. Returns
    the whole codec tree (encoder backbone, quantizer both ways, HiFiGAN
    head) on `device`."""
    device = resolve_device(device)
    path = Path(checkpoint)
    if path.is_dir():
        path = _find_weights_file(path, FIREFLY_FILES)
    r = _Reader(path, dtype, device)
    infix = "" if cfg.version == FishVersion.V1_2 else "conv."

    def conv(name: str, w_shape, n_out=None) -> Dict[str, torch.Tensor]:
        """Conv (O, I/g, K), or conv-transpose (I, O, K) with n_out = O."""
        return {"w": r.get(f"{name}.weight", w_shape),
                "b": r.get(f"{name}.bias", (w_shape[0] if n_out is None else n_out,))}

    def fish_conv(name: str, w_shape, n_out=None) -> Dict[str, torch.Tensor]:
        return conv(f"{name}.{infix}".rstrip("."), w_shape, n_out)

    def norm(name: str, dim: int) -> Dict[str, torch.Tensor]:
        return {"w": r.get(f"{name}.weight", (dim,)), "b": r.get(f"{name}.bias", (dim,))}

    def linear_t(name: str, n_in: int, n_out: int) -> Dict[str, torch.Tensor]:
        p = {"w": r.linear_t(f"{name}.weight", n_in, n_out)}
        if r.has(f"{name}.bias"):
            p["b"] = r.get(f"{name}.bias", (n_out,))
        return p

    def block(name: str, dim: int, k: int = 7) -> Dict:
        p = {
            "dwconv": fish_conv(f"{name}.dwconv", (dim, 1, k)),
            "norm": norm(f"{name}.norm", dim),
            "pwconv1": linear_t(f"{name}.pwconv1", dim, 4 * dim),
            "pwconv2": linear_t(f"{name}.pwconv2", 4 * dim, dim),
        }
        if r.has(f"{name}.gamma"):
            p["gamma"] = r.get(f"{name}.gamma", (dim,))
        return p

    bb = cfg.backbone
    backbone = {
        "stem": {
            "conv": fish_conv("backbone.downsample_layers.0.0",
                              (bb.dims[0], bb.input_channels, bb.kernel_size)),
            "norm": norm("backbone.downsample_layers.0.1", bb.dims[0]),
            "blocks": [block(f"backbone.stages.0.{j}", bb.dims[0], bb.kernel_size)
                       for j in range(bb.depths[0])],
        },
        "mid": [
            {
                "norm": norm(f"backbone.downsample_layers.{i}.0", bb.dims[i - 1]),
                "conv": conv(f"backbone.downsample_layers.{i}.1", (bb.dims[i], bb.dims[i - 1], 1)),
                "blocks": [block(f"backbone.stages.{i}.{j}", bb.dims[i], bb.kernel_size)
                           for j in range(bb.depths[i])],
            }
            for i in range(1, len(bb.depths))
        ],
        "final_norm": norm("backbone.norm", bb.dims[-1]),
    }

    q = cfg.quantizer
    dims = q.all_dims
    dim_g, d_cb = dims[-1] // q.n_groups, len(q.levels)
    quantizer = {
        "downsample": [
            {"conv": fish_conv(f"quantizer.downsample.{i}.0", (dims[i + 1], dims[i], f)),
             "block": block(f"quantizer.downsample.{i}.1", dims[i + 1])}
            for i, f in enumerate(q.downsample_factor)
        ],
        "upsample": [  # conv-transpose weights are (I, O, K)
            {"conv": fish_conv(f"quantizer.upsample.{i}.0", (dims[i + 1], dims[i], f), dims[i]),
             "block": block(f"quantizer.upsample.{i}.1", dims[i])}
            for i, f in enumerate(q.downsample_factor)
        ],
        "rvqs": [
            {"project_in": linear_t(f"quantizer.residual_fsq.rvqs.{g}.project_in", dim_g, d_cb),
             "project_out": linear_t(f"quantizer.residual_fsq.rvqs.{g}.project_out", d_cb,
                                     dim_g)}
            for g in range(q.n_groups)
        ],
    }

    h = cfg.head
    ch0 = h.upsample_initial_channel
    ups, resblocks = [], []
    for i, k in enumerate(h.upsample_kernel_sizes):
        ci, co = ch0 // 2**i, ch0 // 2 ** (i + 1)
        ups.append(fish_conv(f"head.ups.{i}", (ci, co, k), co))
        resblocks.append([
            {f"convs{n}": [fish_conv(f"head.resblocks.{i}.blocks.{j}.convs{n}.{t}", (co, co, rk))
                           for t in range(len(h.resblock_dilation_sizes[j]))]
             for n in (1, 2)}
            for j, rk in enumerate(h.resblock_kernel_sizes)
        ])
    head = {
        "conv_pre": fish_conv("head.conv_pre", (ch0, h.num_mels, h.pre_conv_kernel_size)),
        "ups": ups,
        "resblocks": resblocks,
        "conv_post": fish_conv("head.conv_post", (1, ch0 // 2 ** len(h.upsample_rates),
                                                h.post_conv_kernel_size)),
    }
    return {"backbone": backbone, "quantizer": quantizer, "head": head}


# --------------------------------------------------------------------------
# Writing
# --------------------------------------------------------------------------


def save_safetensors(path: str | Path, tensors: Dict[str, torch.Tensor]) -> None:
    """Write {name: tensor on any device} (or numpy arrays) as safetensors:
    names sorted, the header padded with spaces to a multiple of 8 bytes,
    each tensor copied to the host only when it is written."""
    codes = {dt: code for code, dt in _SAFETENSORS_DTYPES.items()}
    names = sorted(tensors)
    ts = {n: torch.as_tensor(tensors[n]) for n in names}
    header: Dict[str, Dict] = {}
    off = 0
    for name in names:
        t = ts[name]
        if t.dtype not in codes:
            raise ValueError(f"unsupported dtype {t.dtype} for {name!r}")
        n = t.numel() * t.dtype.itemsize
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for name in names:
            t = ts[name].detach().contiguous().cpu().reshape(-1)
            if t.numel():
                f.write(memoryview(t.view(torch.uint8).numpy()))


def save_lm_params(path: str | Path, params: Dict, cfg: DualARConfig) -> None:
    """Inverse of load_lm_params: the parameter tree as a safetensors
    file in the upstream names and layouts (linears back to (out, in),
    stacks unstacked; no output.weight when the embeddings are tied)."""
    tensors: Dict[str, torch.Tensor] = {}

    def unstack(prefix: str, stack: Dict) -> None:
        for i in range(stack["wqkv"].shape[0]):
            p = f"{prefix}.{i}"
            tensors[f"{p}.attention.wqkv.weight"] = stack["wqkv"][i].T
            tensors[f"{p}.attention.wo.weight"] = stack["wo"][i].T
            tensors[f"{p}.feed_forward.w1.weight"] = stack["w1"][i].T
            tensors[f"{p}.feed_forward.w3.weight"] = stack["w3"][i].T
            tensors[f"{p}.feed_forward.w2.weight"] = stack["w2"][i].T
            tensors[f"{p}.attention_norm.weight"] = stack["attention_norm"][i]
            tensors[f"{p}.ffn_norm.weight"] = stack["ffn_norm"][i]

    for key in ("embeddings", "codebook_embeddings", "fast_embeddings", "norm", "fast_norm"):
        tensors[f"{key}.weight"] = params[key]
    tensors["fast_output.weight"] = params["fast_output"].T
    if not cfg.tie_word_embeddings:
        tensors["output.weight"] = params["output"].T
    unstack("layers", params["slow"])
    unstack("fast_layers", params["fast"])
    save_safetensors(path, tensors)


def firefly_state_dict(params: Dict, cfg: FireflyConfig) -> Dict[str, torch.Tensor]:
    """Inverse of load_firefly_params: {upstream name: tensor}."""
    infix = "" if cfg.version == FishVersion.V1_2 else "conv."
    sd: Dict[str, torch.Tensor] = {}

    def put_conv(name: str, p: Dict, fish: bool = True) -> None:
        pre = f"{name}.{infix}".rstrip(".") if fish else name
        sd[f"{pre}.weight"], sd[f"{pre}.bias"] = p["w"], p["b"]

    def put_norm(name: str, p: Dict) -> None:
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["w"], p["b"]

    def put_linear(name: str, p: Dict) -> None:
        sd[f"{name}.weight"] = p["w"].T
        if "b" in p:
            sd[f"{name}.bias"] = p["b"]

    def put_block(name: str, blk: Dict) -> None:
        put_conv(f"{name}.dwconv", blk["dwconv"])
        put_norm(f"{name}.norm", blk["norm"])
        put_linear(f"{name}.pwconv1", blk["pwconv1"])
        put_linear(f"{name}.pwconv2", blk["pwconv2"])
        if "gamma" in blk:
            sd[f"{name}.gamma"] = blk["gamma"]

    bb = params["backbone"]
    put_conv("backbone.downsample_layers.0.0", bb["stem"]["conv"])
    put_norm("backbone.downsample_layers.0.1", bb["stem"]["norm"])
    for j, blk in enumerate(bb["stem"]["blocks"]):
        put_block(f"backbone.stages.0.{j}", blk)
    for i, mid in enumerate(bb["mid"], start=1):
        put_norm(f"backbone.downsample_layers.{i}.0", mid["norm"])
        put_conv(f"backbone.downsample_layers.{i}.1", mid["conv"], fish=False)
        for j, blk in enumerate(mid["blocks"]):
            put_block(f"backbone.stages.{i}.{j}", blk)
    put_norm("backbone.norm", bb["final_norm"])
    q = params["quantizer"]
    for kind in ("downsample", "upsample"):
        for i, st in enumerate(q[kind]):
            put_conv(f"quantizer.{kind}.{i}.0", st["conv"])
            put_block(f"quantizer.{kind}.{i}.1", st["block"])
    for g, rvq in enumerate(q["rvqs"]):
        put_linear(f"quantizer.residual_fsq.rvqs.{g}.project_in", rvq["project_in"])
        put_linear(f"quantizer.residual_fsq.rvqs.{g}.project_out", rvq["project_out"])
    h = params["head"]
    put_conv("head.conv_pre", h["conv_pre"])
    for i, up in enumerate(h["ups"]):
        put_conv(f"head.ups.{i}", up)
    for i, stage in enumerate(h["resblocks"]):
        for j, rb in enumerate(stage):
            for n in (1, 2):
                for t, c in enumerate(rb[f"convs{n}"]):
                    put_conv(f"head.resblocks.{i}.blocks.{j}.convs{n}.{t}", c)
    put_conv("head.conv_post", h["conv_post"])
    return sd


def save_firefly_params(path: str | Path, params: Dict, cfg: FireflyConfig) -> None:
    """The whole codec tree as a safetensors file in the upstream names."""
    save_safetensors(path, firefly_state_dict(params, cfg))
