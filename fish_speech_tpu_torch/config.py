"""Version registry and model/codec configuration.

The port's own copy of the JAX package's `config.py`: plain frozen
dataclasses, field-compatible with the checkpoint `config.json` files.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from pathlib import Path
from typing import Optional, Tuple


class FishVersion(enum.Enum):
    """Fish Speech checkpoint generation."""

    V1_2 = "1.2"
    V1_4 = "1.4"
    V1_5 = "1.5"


class WhichModel(enum.Enum):
    """User-facing model selector (the CLIs' --fish-version)."""

    FISH_1_2 = "1.2"
    FISH_1_4 = "1.4"
    FISH_1_5 = "1.5"
    DUAL_AR = "dual_ar"

    @property
    def fish_version(self) -> Optional[FishVersion]:
        return {
            WhichModel.FISH_1_2: FishVersion.V1_2,
            WhichModel.FISH_1_4: FishVersion.V1_4,
            WhichModel.FISH_1_5: FishVersion.V1_5,
        }.get(self)


class WhichLM(enum.Enum):
    """LM family: Fish (per-version quirks) or generic DualAR."""

    FISH_1_2 = "fish_1.2"
    FISH_1_4 = "fish_1.4"
    FISH_1_5 = "fish_1.5"
    DUAL_AR = "dual_ar"

    @staticmethod
    def from_model(model: WhichModel) -> "WhichLM":
        return {
            WhichModel.FISH_1_2: WhichLM.FISH_1_2,
            WhichModel.FISH_1_4: WhichLM.FISH_1_4,
            WhichModel.FISH_1_5: WhichLM.FISH_1_5,
            WhichModel.DUAL_AR: WhichLM.DUAL_AR,
        }[model]

    @property
    def fish_version(self) -> Optional[FishVersion]:
        return {
            WhichLM.FISH_1_2: FishVersion.V1_2,
            WhichLM.FISH_1_4: FishVersion.V1_4,
            WhichLM.FISH_1_5: FishVersion.V1_5,
        }.get(self)

    @property
    def uses_explicit_semantic_ids(self) -> bool:
        """1.5/DualAR encode semantic codes as distinct `<|semantic:N|>`
        vocab tokens; 1.2/1.4 use one `<|semantic|>` pad token and the
        slow head only chooses PAD vs `<|im_end|>`."""
        return self in (WhichLM.FISH_1_5, WhichLM.DUAL_AR)


class WhichCodec(enum.Enum):
    """Audio codec selector."""

    FIREFLY_1_2 = "firefly_1.2"
    FIREFLY_1_4 = "firefly_1.4"
    FIREFLY_1_5 = "firefly_1.5"
    MIMI = "mimi"

    @staticmethod
    def from_model(model: WhichModel) -> "WhichCodec":
        return {
            WhichModel.FISH_1_2: WhichCodec.FIREFLY_1_2,
            WhichModel.FISH_1_4: WhichCodec.FIREFLY_1_4,
            WhichModel.FISH_1_5: WhichCodec.FIREFLY_1_5,
            WhichModel.DUAL_AR: WhichCodec.MIMI,
        }[model]


# --------------------------------------------------------------------------
# DualAR language model config
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DualARConfig:
    """Architecture hyperparameters for the DualAR transformer."""

    vocab_size: int
    n_layer: int
    n_fast_layer: int
    n_head: int
    dim: int
    intermediate_size: Optional[int]
    n_local_heads: int
    head_dim: int
    rope_base: float
    norm_eps: float
    max_seq_len: int
    codebook_size: int
    num_codebooks: int
    tie_word_embeddings: bool = False
    attention_qkv_bias: bool = False  # the model has no qkv bias: loading refuses True
    depthwise_wte: bool = False
    depthwise_output: bool = False
    initializer_range: float = 0.02

    @property
    def ffn_dim(self) -> int:
        return self.intermediate_size if self.intermediate_size else self.dim * 4

    @property
    def fast_vocab_size(self) -> int:
        """Rows of fast_embeddings."""
        if self.depthwise_wte:
            return (self.num_codebooks - 1) * self.codebook_size
        return self.codebook_size

    @property
    def fast_output_size(self) -> int:
        """Columns of fast_output."""
        if self.depthwise_output:
            return self.codebook_size * self.num_codebooks
        return self.codebook_size

    @staticmethod
    def fish_speech_1_2() -> "DualARConfig":
        return DualARConfig(
            vocab_size=32000,
            n_layer=24,
            n_fast_layer=4,
            n_head=16,
            dim=1024,
            intermediate_size=4096,
            n_local_heads=2,
            head_dim=64,
            rope_base=1_000_000.0,
            norm_eps=1e-6,
            max_seq_len=4096,
            codebook_size=1024,
            num_codebooks=4,
        )

    @staticmethod
    def fish_speech_1_5() -> "DualARConfig":
        """Fish 1.5: the 1.2 backbone with 8 codebooks and the ~100k
        vocab that carries `<|semantic:N|>` tokens."""
        return dataclasses.replace(
            DualARConfig.fish_speech_1_2(),
            vocab_size=102048,
            num_codebooks=8,
        )

    @staticmethod
    def from_json(path: str | Path) -> "DualARConfig":
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(DualARConfig)}
        kwargs = {k: v for k, v in raw.items() if k in fields}
        for flag in ("depthwise_wte", "depthwise_output"):
            if kwargs.get(flag) is None:
                kwargs[flag] = False
        return DualARConfig(**kwargs)


@dataclasses.dataclass(frozen=True)
class TokenConfig:
    """Resolved special-token ids."""

    im_end_id: int
    pad_id: int
    semantic_start_id: int
    semantic_end_id: Optional[int]

    @staticmethod
    def from_tokenizer(lm: WhichLM, tokenizer, config: DualARConfig) -> "TokenConfig":
        """`tokenizer`: anything with `token_to_id(str) -> Optional[int]`
        (a `tokenizers.Tokenizer`, or a stand-in). The fallback ids 100012
        and 5 are the JAX package's."""
        im_end_id = tokenizer.token_to_id("<|im_end|>")
        if im_end_id is None:
            raise ValueError("Tokenizer does not have <|im_end|>")
        if lm.uses_explicit_semantic_ids:
            semantic_start_id = tokenizer.token_to_id("<|semantic:0|>")
            if semantic_start_id is None:
                semantic_start_id = 100012
            semantic_end_id = tokenizer.token_to_id(
                f"<|semantic:{config.codebook_size - 1}|>")
        else:
            semantic_start_id = tokenizer.token_to_id("<|semantic|>")
            if semantic_start_id is None:
                semantic_start_id = 5
            semantic_end_id = None
        pad_id = tokenizer.token_to_id("<|semantic|>")
        if pad_id is None:
            pad_id = 5
        return TokenConfig(im_end_id=im_end_id, pad_id=pad_id,
                           semantic_start_id=semantic_start_id,
                           semantic_end_id=semantic_end_id)


# --------------------------------------------------------------------------
# Firefly codec config
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpecTransformConfig:
    """The codec's audio: sample rate, and the log-mel front end's
    framing (`audio/mel.py`)."""

    sample_rate: int = 44100
    n_mels: int = 160
    n_fft: int = 2048
    hop_length: int = 512


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """The ConvNeXt encoder of the codec (encode side)."""

    input_channels: int = 160
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (128, 256, 384, 512)
    kernel_size: int = 7


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    num_mels: int = 512
    upsample_initial_channel: int = 512
    pre_conv_kernel_size: int = 13
    post_conv_kernel_size: int = 13


@dataclasses.dataclass(frozen=True)
class DownsampleFSQConfig:
    input_dim: int = 512
    n_codebooks: int = 1  # residual quantizers per group
    n_groups: int = 8
    levels: Tuple[int, ...] = (8, 5, 5, 5)
    downsample_factor: Tuple[int, ...] = (2, 2)
    downsample_dims: Optional[Tuple[int, ...]] = None

    @property
    def all_dims(self) -> Tuple[int, ...]:
        if self.downsample_dims is not None:
            return (self.input_dim,) + tuple(self.downsample_dims)
        return (self.input_dim,) * (len(self.downsample_factor) + 1)

    @property
    def total_downsample(self) -> int:
        out = 1
        for f in self.downsample_factor:
            out *= f
        return out

    @property
    def num_semantic_codebooks(self) -> int:
        """Codebook rows an encode gives: groups * quantizers."""
        return self.n_groups * self.n_codebooks

    @staticmethod
    def firefly_1_2() -> "DownsampleFSQConfig":
        return DownsampleFSQConfig(
            n_groups=4, downsample_factor=(2,), levels=(8, 5, 5, 5)
        )

    @staticmethod
    def firefly_1_4() -> "DownsampleFSQConfig":
        return DownsampleFSQConfig(
            n_groups=8, downsample_factor=(2, 2), levels=(8, 5, 5, 5)
        )


@dataclasses.dataclass(frozen=True)
class FireflyConfig:
    """Firefly codec config: the mel front end and ConvNeXt backbone
    (encode), the downsampling FSQ quantizer (both directions) and the
    HiFiGAN head (decode)."""

    spec_transform: SpecTransformConfig = SpecTransformConfig()
    backbone: BackboneConfig = BackboneConfig()
    head: HiFiGANConfig = HiFiGANConfig()
    quantizer: DownsampleFSQConfig = DownsampleFSQConfig()
    version: FishVersion = FishVersion.V1_5

    @staticmethod
    def for_version(version: FishVersion) -> "FireflyConfig":
        if version == FishVersion.V1_2:
            return FireflyConfig(
                quantizer=DownsampleFSQConfig.firefly_1_2(), version=version
            )
        return FireflyConfig(
            quantizer=DownsampleFSQConfig.firefly_1_4(), version=version
        )

    @property
    def frame_rate(self) -> float:
        """Semantic tokens per second of audio."""
        return self.spec_transform.sample_rate / self.samples_per_frame

    @property
    def samples_per_frame(self) -> int:
        return self.spec_transform.hop_length * self.quantizer.total_downsample


def default_rep_pen(lm: WhichLM) -> float:
    """1.4 for Fish 1.5, 1.2 for earlier."""
    return 1.4 if lm == WhichLM.FISH_1_5 else 1.2
