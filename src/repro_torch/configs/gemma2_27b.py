"""Gemma-2 27B. [arXiv:2408.00118; hf] — local(4096-window)/global
alternating attention, attention and final-logit soft-capping."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
    vocab=256000, head_dim=128,
    window=4096, alternate_local_global=True,
    attn_softcap=50.0, logit_softcap=30.0,
)
