"""Data pipeline, as the JAX package's ``train/data.py`` defines it (pure
numpy: one seed gives both packages the same batches).

Deterministic, seekable synthetic LM token stream: batch ``i`` is a pure
function of ``(seed, i)``, so checkpoint/restart replays the stream exactly
(fault tolerance requires a seekable iterator — the restore path just sets
``next_index``).  On a real cluster each host materializes only its
``(host_id, n_hosts)`` slice of the global batch; on this container the
slice is the whole batch.

The generator fabricates structure (a small Markov chain over the vocab) so
training loss measurably decreases — enough signal to validate the training
loop end-to-end without shipping a corpus.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    n_states: int = 64          # Markov states (learnable structure)


class TokenStream:
    """Seekable synthetic token stream."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.next_index = 0
        root = np.random.default_rng(cfg.seed)
        k = min(cfg.n_states, cfg.vocab)
        # Sparse-ish row-stochastic transition over k anchor tokens.
        logits = root.standard_normal((k, k)) * 2.0
        self._P = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        self._anchors = root.choice(cfg.vocab, size=k, replace=False)

    @property
    def local_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.n_hosts

    def _gen(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, index, cfg.host_id))  # pure function of position
        B, L, k = self.local_batch, cfg.seq_len, self._P.shape[0]
        states = np.empty((B, L + 1), np.int64)
        states[:, 0] = rng.integers(0, k, B)
        u = rng.random((B, L))
        cum = np.cumsum(self._P, axis=1)
        for t in range(L):
            states[:, t + 1] = np.argmax(
                u[:, t][:, None] < cum[states[:, t]], axis=1)
        toks = self._anchors[states].astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self._gen(self.next_index)
        self.next_index += 1
        return batch

    # -- checkpointable iterator state --------------------------------------
    def state_dict(self) -> dict:
        return {"next_index": self.next_index, "seed": self.cfg.seed}

    def load_state_dict(self, state: dict) -> None:
        assert state["seed"] == self.cfg.seed, "data seed mismatch on restore"
        self.next_index = int(state["next_index"])
