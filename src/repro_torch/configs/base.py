"""Architecture config system.

Every assigned architecture is an :class:`ArchConfig`; ``--arch <id>`` in the
launchers resolves through :func:`get_config`.  ``reduced()`` shrinks any
config to a CPU-smoke-test size of the same family (same code paths, small
dims).  Shape cells (train_4k / prefill_32k / decode_32k / long_500k) and
their applicability rules live here too.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

ARCH_IDS = [
    "llama4-scout-17b-a16e", "olmoe-1b-7b", "minicpm-2b", "minitron-8b",
    "gemma2-27b", "yi-9b", "zamba2-7b", "whisper-medium", "internvl2-2b",
    "mamba2-130m",
]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str              # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden (olmoe: 1024)
    shared_expert_d_ff: int = 0      # llama4 shared expert

    # attention flavor
    window: int = 0                  # sliding-window size for local layers
    alternate_local_global: bool = False   # gemma2
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: int = 0              # zamba2: shared attn block period

    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_frames: int = 1500           # stub frontend sequence length

    # vlm
    n_patches: int = 0               # stub patch-embedding prefix length

    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq: int = 532480            # rope table upper bound

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding /
        unembedding / logits shard evenly on a 16-way axis (the standard
        padded-vocab trick; real token ids stay < vocab, padded logit
        columns are masked in the loss)."""
        return -(-self.vocab // 256) * 256

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.family == "audio"

    # -- shape applicability (DESIGN.md §4) ---------------------------------
    def supports(self, shape_name: str) -> Tuple[bool, str]:
        cell = SHAPES[shape_name]
        if cell.name == "long_500k":
            if self.family in ("ssm", "hybrid"):
                return True, ""
            return False, ("full-attention arch: 500k decode is quadratic "
                           "(skip per assignment; see DESIGN.md §4)")
        if cell.kind == "decode" and self.family == "audio":
            # whisper has a decoder; decode_32k exercises a 32k-frame
            # (stub) encoder memory — lowering-path exercise only.
            return True, ""
        return True, ""

    def reduced(self) -> "ArchConfig":
        """Smoke-test config: same family/code paths, tiny dims."""
        kv = max(1, min(self.n_kv_heads, 2))
        heads = max(kv, 4)
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4) if self.attn_every == 0
            else 2 * self.attn_every + 1,
            d_model=64, n_heads=heads, n_kv_heads=kv, head_dim=16,
            d_ff=128, vocab=256,
            n_experts=min(self.n_experts, 4) or 0,
            top_k=min(self.top_k, 2) or 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            shared_expert_d_ff=64 if self.shared_expert_d_ff else 0,
            window=min(self.window, 64) if self.window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=8 if self.ssm_state else 64,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_frames=32,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            max_seq=4096,
        )


_MODULES = {a: a.replace("-", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
