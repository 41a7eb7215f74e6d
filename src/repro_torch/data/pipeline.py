"""Deterministic synthetic token stream.  Counterpart of
:mod:`repro.data.pipeline` (``DataConfig``, ``global_batch``,
``DataIterator``).

Batch ``i`` is a pure function of ``(seed, i)``: the same numpy generator,
draws and bigram mixing as the reference, so the port's batches equal the
reference's bit for bit; the trainer moves them to the device.  A
Zipf-weighted unigram stream where with probability 0.5 the next token is
a fixed function of the previous one gives a learnable, decreasing loss.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_codebooks: int = 1
    n_vision_tokens: int = 0
    d_model: int = 0


@dataclasses.dataclass
class DataState:
    step: int = 0


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([cfg.seed, step, 0xFA05]))


def _synthetic_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    flat = rng.choice(vocab, size=int(np.prod(shape)), p=probs).reshape(shape)
    succ_mult = 6364136223846793005 % vocab or 1
    mix = rng.random(shape) < 0.5
    out = flat.copy()
    for t in range(1, shape[-1]):
        prev = out[..., t - 1]
        out[..., t] = np.where(mix[..., t], (prev * succ_mult + 13) % vocab, flat[..., t])
    return out.astype(np.int32)


def global_batch(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """The global batch of ``step`` as numpy: ``{"tokens": (B, S) int32}``."""
    if cfg.n_codebooks > 1 or cfg.n_vision_tokens:
        raise NotImplementedError("audio and vision batches come with the modality front ends (a later slice)")
    rng = _batch_rng(cfg, step)
    return {"tokens": _synthetic_tokens(rng, (cfg.global_batch, cfg.seq_len), cfg.vocab)}


class DataIterator:
    """Iterator over ``global_batch(cfg, 0), global_batch(cfg, 1), ...``."""

    def __init__(self, cfg: DataConfig, state: DataState | None = None):
        self.cfg = cfg
        self.state = state or DataState()

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = global_batch(self.cfg, self.state.step)
        self.state.step += 1
        return b

    def checkpoint_state(self) -> dict:
        return {"step": self.state.step}

    def restore_state(self, s: dict) -> None:
        self.state.step = int(s["step"])
