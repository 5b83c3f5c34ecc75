"""Llama-4 Scout 17B-active / 16 experts.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] — 48L, d_model=5120,
40 heads (GQA kv=8), MoE 16 experts top-1 with a shared expert (d_ff=8192),
vocab 202048.  Early-fusion multimodality is out of scope for the LM cells
(text shapes only).  The MoE dispatch uses the SEM-SpMM capacity-gather path
(DESIGN.md §3)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, head_dim=128,
    n_experts=16, top_k=1, moe_d_ff=8192, shared_expert_d_ff=8192,
    rope_theta=500000.0,
)
