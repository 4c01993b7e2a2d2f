"""Deterministic synthetic token pipeline, a copy of
``repro.training.data`` (numpy, so the tokens are the reference's, bit for
bit).

Host-side, seedable, shardable: each (step, shard) pair derives its chunk of
the global batch independently, so data loading is reproducible across
restarts and elastic resharding (a worker only materialises its slice).
A real deployment would swap ``_tokens_for`` for a tokenised corpus reader
with the same (step, index-range) contract.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _tokens_for(cfg: DataConfig, step: int, row: int) -> np.ndarray:
    """One (seq_len,) row; Zipf-ish marginal + order-2 structure so the LM
    has something learnable (loss must drop during the example run)."""
    rng = np.random.default_rng((cfg.seed, step, row))
    base = rng.zipf(1.4, size=cfg.seq_len) % cfg.vocab
    # inject copy structure: every other position repeats with offset
    base[1::2] = (base[0::2] + 1) % cfg.vocab
    return base.astype(np.int32)


def global_batch(cfg: DataConfig, step: int) -> dict:
    toks = np.stack([_tokens_for(cfg, step, r) for r in range(cfg.global_batch)])
    return {"tokens": toks, "labels": toks}


def shard_batch(cfg: DataConfig, step: int, shard: int, n_shards: int) -> dict:
    per = cfg.global_batch // n_shards
    rows = range(shard * per, (shard + 1) * per)
    toks = np.stack([_tokens_for(cfg, step, r) for r in rows])
    return {"tokens": toks, "labels": toks}
