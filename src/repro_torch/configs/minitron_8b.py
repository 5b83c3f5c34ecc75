"""Minitron-8B (pruned Nemotron). [arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=16384,
    vocab=256000, head_dim=128,
)
