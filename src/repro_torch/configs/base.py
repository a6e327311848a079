"""Architecture registry (``--arch <id>``).

A copy of the reference's registry: the ``CNNConfig`` of the paper's two
CIFAR models, the reference's ``ModelConfig`` with every transformer LM
of its zoo (dense, sliding-window, MoE, RG-LRU hybrid, RWKV6,
encoder-decoder audio and VLM), and the input shapes assigned to the
paper (``INPUT_SHAPES``).  Configs are pure data; ``repro_torch.models``
interprets them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Layer kinds used in ``layer_pattern`` (repeating pattern over depth).
GLOBAL = "global"   # full (causal) attention
LOCAL = "local"     # sliding-window attention
RGLRU = "rglru"     # RG-LRU recurrent block (RecurrentGemma / Griffin)
RWKV = "rwkv"       # RWKV6 time-mix block (attention-free)


@dataclass(frozen=True)
class CNNConfig:
    name: str
    family: str = "cnn"
    kind: str = "mobilenet"            # mobilenet | resnet18
    num_classes: int = 10
    image_size: int = 32
    channels: int = 3
    width_mult: float = 1.0
    dtype: str = "float32"
    citation: str = ""

    def reduced(self, **_):
        return dataclasses.replace(self, width_mult=0.25)


@dataclass(frozen=True)
class ModelConfig:
    """The reference's ``ModelConfig`` (``repro/configs/base.py``), field
    for field, with its ``reduced()``."""
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    citation: str = ""

    # --- attention ---
    head_dim: Optional[int] = None       # default: d_model // n_heads
    window: int = 4096                   # sliding-window size for LOCAL layers
    layer_pattern: Tuple[str, ...] = (GLOBAL,)
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mlp: str = "swiglu"                  # swiglu | gelu

    # --- mixture of experts ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- encoder-decoder (audio) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500              # stub conv-frontend frame count

    # --- vlm ---
    n_patches: int = 0                   # stub ViT-frontend patch count

    # --- rwkv ---
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 64

    # --- rglru ---
    rglru_width: int = 0                 # recurrence width (default d_model)
    conv_width: int = 4

    # --- long-context policy ---
    long_context: str = "swa"

    # --- numerics ---
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.rglru_width == 0:
            object.__setattr__(self, "rglru_width", self.d_model)
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads {self.n_heads} not "
                             f"divisible by n_kv_heads {self.n_kv_heads}")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return all(k in (RWKV, RGLRU) for k in self.layer_pattern)

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        n_heads = max(1, min(self.n_heads, d_model // 64))
        ratio = max(1, self.n_heads // self.n_kv_heads)
        n_kv = max(1, n_heads // min(ratio, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        pat = self.layer_pattern[:max(1, n_layers)]
        changes = dict(
            n_layers=n_layers, d_model=d_model, head_dim=None,
            n_heads=n_heads, n_kv_heads=n_kv, d_ff=2 * d_model,
            vocab_size=min(self.vocab_size, vocab),
            window=min(self.window, 64),
            layer_pattern=pat,
            rwkv_head_dim=min(self.rwkv_head_dim, 32),
            rwkv_lora_rank=16,
            rglru_width=0,
            encoder_seq=32, n_patches=min(self.n_patches, 8),
            n_encoder_layers=min(self.n_encoder_layers, 2),
            dtype="float32",
        )
        if self.is_moe:
            changes.update(n_experts=4, experts_per_token=2)
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# The input shapes assigned to the paper (the reference's ``INPUT_SHAPES``).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict = {}


def register(cfg):
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all():
    import importlib
    for mod in _ALL_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str):
    if name not in _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def all_arch_names():
    """Every registered architecture's name, sorted."""
    _load_all()
    return sorted(_REGISTRY)


_ALL_MODULES = ["mobilenet_cifar", "resnet18_cifar", "smollm_135m",
                "phi3_mini_3_8b", "qwen1_5_4b", "gemma3_4b", "rwkv6_7b",
                "mixtral_8x7b", "mixtral_8x22b", "recurrentgemma_2b",
                "whisper_small", "pixtral_12b"]
