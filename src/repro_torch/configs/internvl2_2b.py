"""InternVL2-2B. [arXiv:2404.16821; hf] — InternLM2-1.8B backbone
(24L, d_model=2048, 16H kv=8, d_ff=8192, vocab 92553); the InternViT
frontend is a STUB: input_specs() provides precomputed patch embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab=92553, n_patches=256,
)
