"""Whisper-medium. [arXiv:2212.04356; unverified] — encoder-decoder,
24 enc + 24 dec layers, d_model=1024, 16H, d_ff=4096, vocab 51865.
The conv audio frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (batch, frames, d_model)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, n_enc_layers=24, enc_frames=1500,
)
