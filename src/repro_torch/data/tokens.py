"""Synthetic LM token pipeline: deterministic, step-indexed, restart-safe;
the counterpart of ``repro.data.tokens`` (host numpy, the reference's code,
so both packages draw the same batches).

``TokenStream.batch_at(step)`` is a pure function of (seed, step) so a
restarted job resumes the exact stream — the checkpoint stores only
(seed, next_step). Data follows a Zipf unigram distribution with a
repeated-ngram structure so the model has something learnable (loss
decreases over a few hundred steps in the end-to-end example).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenStream"]


@dataclasses.dataclass
class TokenStream:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    zipf_a: float = 1.2

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed << 32) ^ step)
        # zipf-ish unigrams, clipped to vocab
        base = rng.zipf(self.zipf_a, size=(self.batch, self.seq + 1))
        toks = (base - 1) % self.vocab
        # inject learnable bigram structure: token t+1 = f(t) half the time
        follow = (toks[:, :-1] * 31 + 7) % self.vocab
        mask = rng.random((self.batch, self.seq)) < 0.5
        toks[:, 1:] = np.where(mask, follow, toks[:, 1:])
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def state(self, next_step: int) -> dict:
        return {"seed": self.seed, "next_step": next_step}

    @classmethod
    def from_state(cls, vocab, batch, seq, state: dict) -> "TokenStream":
        return cls(vocab=vocab, batch=batch, seq=seq, seed=state["seed"])
