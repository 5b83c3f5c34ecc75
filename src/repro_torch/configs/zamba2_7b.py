"""Zamba2-7B. [arXiv:2411.15242; unverified] — Mamba2 backbone with a
shared attention+MLP block applied periodically (every 6 layers here),
ssm_state=64.  long_500k runs (hybrid): SSM state is O(1), the shared-attn
KV cache uses the SEM host tier (DESIGN.md §3)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, head_dim=112,
    ssm_state=64, ssm_head_dim=64, attn_every=6,
)
