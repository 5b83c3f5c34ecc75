"""OLMoE 1B-active / 7B-total. [arXiv:2409.02060; hf]

16L, d_model=2048, 16H (kv=16, i.e. MHA), 64 experts top-8 with per-expert
d_ff=1024, vocab 50304.  The 64e/top-8 routing skew exercises the power-law
load-balance machinery."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50304,
    n_experts=64, top_k=8, moe_d_ff=1024,
)
