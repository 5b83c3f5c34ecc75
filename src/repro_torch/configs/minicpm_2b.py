"""MiniCPM-2B. [arXiv:2404.06395; hf] — llama-like dense, WSD schedule
(the WSD learning-rate schedule lives in train/optimizer.py)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab=122753,
)
