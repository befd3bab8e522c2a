"""Deterministic synthetic data pipeline (LM tokens, audio frames, M-RoPE).

Documents-as-Markov-chains token stream: learnable structure (so the 100M
example's loss actually falls) while remaining fully offline/deterministic.
Sharded loading: each host materialises only its slice of the global batch
(``host_index``/``host_count``), matching multi-pod data loading.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4          # Markov out-degree: lower = more learnable
    host_index: int = 0
    host_count: int = 1

    def __post_init__(self):
        if self.global_batch % self.host_count:
            raise ValueError("global batch must divide across hosts")
        rng = np.random.RandomState(self.seed)
        v = self.vocab_size
        # sparse Markov transition table: v x branching successor ids
        self._succ = rng.randint(0, v, size=(v, self.branching)).astype(np.int32)

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.host_count

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a step: tokens + next-token labels."""
        b, s = self.local_batch, self.seq_len
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 131 + self.host_index) % (2**31))
        tokens = np.empty((b, s + 1), np.int32)
        tokens[:, 0] = rng.randint(0, self.vocab_size, size=b)
        choices = rng.randint(0, self.branching, size=(b, s))
        for t in range(s):
            tokens[:, t + 1] = self._succ[tokens[:, t], choices[:, t]]
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def batch_iterator(ds: SyntheticLMDataset, start_step: int = 0
                   ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield ds.batch(step)
        step += 1


def make_batch_for(cfg: ModelConfig, batch: int, seq: int, step: int = 0,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """One batch shaped for an architecture (adds modality-stub inputs)."""
    ds = SyntheticLMDataset(cfg.vocab_size if not cfg.logical_vocab_size
                            else cfg.logical_vocab_size,
                            seq, batch, seed=seed)
    out = dict(ds.batch(step))
    rng = np.random.RandomState(seed + step)
    if cfg.is_encoder_decoder:
        out["audio_embeds"] = rng.randn(
            batch, cfg.encoder_seq, cfg.d_model).astype(np.float32) * 0.02
    if cfg.mrope_sections:
        # stub vision frontend: text positions tripled (t=h=w), as for a
        # text-only segment; image patches would carry distinct h/w rows
        pos = np.broadcast_to(np.arange(seq, dtype=np.int32)[None],
                              (batch, seq))
        out["positions"] = np.broadcast_to(pos[None], (3, batch, seq)).copy()
    return out
