"""Deterministic synthetic token stream.  Counterpart of
:mod:`repro.data.pipeline` (``DataConfig``, ``global_batch``,
``host_slice``, ``DataIterator``).

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
    """The global batch of ``step`` as numpy: ``{"tokens": (B, S) int32}``
    (``(B, K, S)`` with ``K = n_codebooks > 1``), and ``"vision_embeds"
    (B, n_vision_tokens, d_model)`` f32 for a vision config."""
    rng = _batch_rng(cfg, step)
    shape = (cfg.global_batch, cfg.seq_len)
    if cfg.n_codebooks > 1:
        shape = (cfg.global_batch, cfg.n_codebooks, cfg.seq_len)
    batch = {"tokens": _synthetic_tokens(rng, shape, cfg.vocab)}
    if cfg.n_vision_tokens:
        embeds = rng.standard_normal((cfg.global_batch, cfg.n_vision_tokens, cfg.d_model), dtype=np.float32)
        batch["vision_embeds"] = embeds * np.float32(0.02)
    return batch


def host_slice(cfg: DataConfig, step: int, host_index: int, n_hosts: int) -> dict[str, np.ndarray]:
    """Host ``host_index``'s contiguous slice of the global batch of
    ``step`` (batch-major, ``global_batch // n_hosts`` rows)."""
    full = global_batch(cfg, step)
    per = cfg.global_batch // n_hosts
    lo, hi = host_index * per, (host_index + 1) * per
    return {k: v[lo:hi] for k, v in full.items()}


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
