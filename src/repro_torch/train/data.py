"""Deterministic synthetic data pipeline (token streams): a copy of
``repro/train/data.py``, which is pure numpy, kept here so that the port
imports nothing of the JAX package.  Batches are bit-equal to the
reference's for the same config and step.

Generates reproducible token batches from a seeded Markov-ish stream with
structure (so loss actually decreases during the example runs).  The
pipeline is *shard-aware*: each data-parallel shard can independently
generate exactly its slice of the global batch — `global_batch(step)` and
`host_shard(step, shard, num_shards)` are bit-consistent.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: int = 97            # ngram period giving learnable structure


class SyntheticLM:
    """tokens[t+1] = (a * tokens[t] + noise) % V with per-sequence keys —
    a next-token distribution a model can learn, cheap to generate."""

    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg

    def _seq(self, seq_key: np.random.Generator) -> np.ndarray:
        c = self.cfg
        a = 1 + seq_key.integers(0, c.structure)
        toks = np.empty(c.seq_len + 1, np.int32)
        toks[0] = seq_key.integers(0, c.vocab_size)
        noise = seq_key.integers(0, 3, size=c.seq_len)
        for t in range(c.seq_len):
            toks[t + 1] = (a * int(toks[t]) + 1 + int(noise[t])) % c.vocab_size
        return toks

    def _batch_rows(self, step: int, rows) -> dict:
        c = self.cfg
        toks = np.stack([
            self._seq(np.random.default_rng((c.seed, step, int(r))))
            for r in rows])
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def global_batch(self, step: int) -> dict:
        return self._batch_rows(step, range(self.cfg.global_batch))

    def host_shard(self, step: int, shard: int, num_shards: int) -> dict:
        c = self.cfg
        per = c.global_batch // num_shards
        return self._batch_rows(step, range(shard * per, (shard + 1) * per))


def make_batch(cfg, cell, step: int = 0, seed: int = 0) -> dict:
    """Concrete (numpy) batch for a ModelConfig x ShapeCell (any object
    with ``seq_len`` and ``global_batch``) — used by the examples and
    integration tests (adds modality stubs)."""
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=cell.seq_len,
                    global_batch=cell.global_batch, seed=seed)
    if cfg.family == "vlm":
        text = cell.seq_len - cfg.num_patches
        dc = dataclasses.replace(dc, seq_len=text)
    batch = SyntheticLM(dc).global_batch(step)
    rng = np.random.default_rng((seed, step, 7))
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            0, 0.02, (cell.global_batch, cfg.num_patches, cfg.d_model)
        ).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            0, 0.02, (cell.global_batch, cfg.encoder_seq, cfg.d_model)
        ).astype(np.float32)
    return batch


def model_batch(cfg, data: SyntheticLM, step: int) -> dict:
    """``data``'s batch ``step`` for a model of ``cfg``: the plain token
    batch, or for an enc-dec or VLM config ``make_batch``'s, which adds
    the modality stub (and for the VLM keeps ``data.cfg.seq_len`` as the
    whole sequence, patches and text)."""
    if cfg.family not in ("encdec", "vlm"):
        return data.global_batch(step)
    return make_batch(cfg, data.cfg, step, seed=data.cfg.seed)
