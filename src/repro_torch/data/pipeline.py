"""Synthetic LM data (a copy of ``repro.data.pipeline``'s numpy generator,
which the port may not import): deterministic, stateless-resumable,
host-sharded token streams.

Token streams come from a seeded Markov-ish generator with Zipfian unigram
statistics, so a model has structure to learn and PTQ perplexities mean
something (the role C4 plays in the paper's calibration). Batch ``t`` is a
pure function of (seed, step, host), and the streams are identical to the
reference's for the same config: the generator is numpy's, copied as it
is. Batches are ``torch.int32`` tensors on the CPU; the caller moves them
to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

__all__ = ["DataConfig", "SyntheticLM", "calibration_stream"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_index: int = 0
    zipf_a: float = 1.2  # unigram skew
    order: int = 2  # markov order for local structure
    grammar_p: float = 0.9  # fraction of tokens drawn from the sparse grammar


class SyntheticLM:
    """Deterministic synthetic token stream with learnable structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self.unigram = (probs / probs.sum()).astype(np.float64)
        # the sparse "grammar" is the language, the same for every stream
        # (train, calibration and evaluation draw different samples of it),
        # so it is seeded independently of cfg.seed
        g_rng = np.random.default_rng(20230707)
        self.n_ctx = 512
        self.succ = g_rng.integers(0, v, size=(self.n_ctx, 8))

    @property
    def host_batch(self) -> int:
        assert self.cfg.global_batch % self.cfg.n_hosts == 0
        return self.cfg.global_batch // self.cfg.n_hosts

    def batch(self, step: int) -> dict:
        """Pure function of (seed, step, host): {'tokens', 'labels'}."""
        c = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([c.seed, step, c.host_index]))
        b, s = self.host_batch, c.seq_len
        toks = np.empty((b, s + 1), dtype=np.int64)
        toks[:, 0] = rng.choice(c.vocab_size, size=b, p=self.unigram)
        ctx = toks[:, 0].copy()
        for t in range(1, s + 1):
            h = (ctx * 1000003 + t // 7) % self.n_ctx
            use_grammar = rng.random(b) < c.grammar_p
            pick = self.succ[h, rng.integers(0, 8, size=b)]
            rand = rng.choice(c.vocab_size, size=b, p=self.unigram)
            toks[:, t] = np.where(use_grammar, pick, rand)
            ctx = (ctx * 31 + toks[:, t]) % (1 << 30)
        return {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
                "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}

    def stream(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def calibration_stream(cfg, n_batches: int, batch: int, seq: int, seed: int = 1234):
    """The paper's calibration set analogue: ``n_batches`` batches of
    ``batch`` x ``seq`` tokens (paper: 128 x 2048 from C4)."""
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed)
    src = SyntheticLM(dc)
    return [src.batch(i) for i in range(n_batches)]
