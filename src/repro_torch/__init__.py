"""PyTorch + CUDA port of the semi-external-memory SpMM system.

The sparse matrix stays on disk in a :class:`~repro_torch.io.storage.TileStore`
and is streamed in chunk batches; the dense operand and the output stay in
device memory, where a hand-written CUDA kernel
(:mod:`repro_torch.kernels.sem_spmm`) applies each batch.  PageRank runs on
top (:mod:`repro_torch.apps.pagerank`).

Every entry point runs on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; with no card present and no ``"cpu"`` request it raises
(see :func:`repro_torch.device.resolve_device`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
