"""Synthetic token pipeline: deterministic, step-keyed, shard-aware.

A copy of the reference's ``repro/data/pipeline.py`` (numpy only, so its
batches are the reference's bit for bit).  Fault-tolerance contract:
``batch_at(step)`` is a pure function of (seed, step, shard), so a restart
from checkpoint step N reproduces the exact token stream; there is no
data-loader state to checkpoint.  The stream mixes Zipf-distributed unigrams
with short repeated motifs, so losses decrease rather than saturate at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch


@dataclass
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard_index: int = 0
    shard_count: int = 1
    frames_shape: Optional[Tuple[int, int]] = None  # (S_enc, d_model) for audio
    patches_shape: Optional[Tuple[int, int]] = None  # (P, d_model) for vlm

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.shard_count == 0, (
            f"global batch {self.global_batch} not divisible by {self.shard_count} shards"
        )
        return self.global_batch // self.shard_count

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard_index])
        )

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        b, s, v = self.local_batch, self.seq_len, self.vocab
        # zipf unigrams, clipped to vocab
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        tokens = (base % max(v - 3, 1)) + 2  # reserve 0=pad, 1=bos
        # splice short repeated motifs (learnable structure)
        n_motifs = max(1, s // 64)
        for i in range(b):
            for _ in range(n_motifs):
                mlen = int(rng.integers(4, 12))
                start = int(rng.integers(0, max(s - 2 * mlen, 1)))
                motif = tokens[i, start : start + mlen]
                dst = int(rng.integers(0, max(s - mlen, 1)))
                tokens[i, dst : dst + mlen] = motif
        tokens[:, 0] = 1  # bos
        tokens = tokens.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1
        batch: Dict[str, np.ndarray] = {"tokens": tokens, "labels": labels.astype(np.int32)}
        if self.frames_shape is not None:
            batch["frames"] = rng.normal(size=(b,) + self.frames_shape).astype(np.float32)
        if self.patches_shape is not None:
            batch["patches"] = rng.normal(size=(b,) + self.patches_shape).astype(np.float32)
        return batch


class BatchSpec(NamedTuple):
    """The shape and dtype of one model input (the reference's ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def make_batch_specs(cfg, shape) -> Dict[str, BatchSpec]:
    """Shape-and-dtype stand-ins for every model input of a train batch."""
    b, s = shape.global_batch, shape.seq_len
    specs = {
        "tokens": BatchSpec((b, s), torch.int32),
        "labels": BatchSpec((b, s), torch.int32),
    }
    if cfg.frontend == "vision":
        specs["patches"] = BatchSpec((b, cfg.encoder_seq, cfg.d_model), torch.float32)
    if cfg.is_encdec:
        specs["frames"] = BatchSpec((b, cfg.encoder_seq, cfg.d_model), torch.float32)
    return specs
