"""Mamba2-130M. [arXiv:2405.21060; unverified] — attention-free SSD
(state-space duality), 24L, d_model=768, ssm_state=128, vocab 50280.
long_500k runs: decode is O(1) per token in the SSM state."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, head_dim=64,
    ssm_state=128, ssm_head_dim=64,
)
