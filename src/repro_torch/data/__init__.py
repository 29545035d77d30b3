"""Deterministic synthetic data pipeline (restart-exact, shard-aware): the
reference's ``repro.data``, numpy only."""

from .pipeline import BatchSpec, SyntheticLMDataset, make_batch_specs

__all__ = ["BatchSpec", "SyntheticLMDataset", "make_batch_specs"]
