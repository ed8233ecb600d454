"""Deterministic, shardable synthetic LM data pipeline.

The port's copy of ``repro.data.pipeline``, unchanged: numpy only, so the
two packages give byte-identical batches for one (seed, step, shard).

Production posture: the stream is a pure function of (seed, step, shard), so
* any host can regenerate any shard of any step — elastic rescale and
  failure recovery need no data-service state;
* checkpoint resume is exact: the loader restarts at ``step`` with identical
  batches (tests assert this bit-for-bit);
* a background thread prefetches ``prefetch`` steps ahead.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    shard: int = 0           # this host's shard index
    num_shards: int = 1
    frames_dim: int = 0      # enc-dec stub: emit frame embeddings too
    frames_len: int = 0


class SyntheticLMStream:
    """Zipf-ish token stream with long-range structure (next-token learnable)."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_shards == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.shard]))
        B, T = self.local_batch, cfg.seq_len
        # markov-ish: token_{t+1} = (a * token_t + noise) % vocab, mixed with
        # zipf draws — gives a learnable but nontrivial distribution
        base = rng.zipf(1.5, size=(B, T + 1)).astype(np.int64) % cfg.vocab
        drift = rng.integers(1, 7, size=(B, 1))
        walk = (np.cumsum(np.ones((B, T + 1), np.int64) * drift, axis=1)
                + base[:, :1]) % cfg.vocab
        mix = rng.random((B, T + 1)) < 0.5
        tokens = np.where(mix, base, walk).astype(np.int32)
        out = {"tokens": tokens}
        if cfg.frames_dim:
            out["frames"] = rng.standard_normal(
                (B, cfg.frames_len, cfg.frames_dim)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class _Prefetcher:
    def __init__(self, stream: SyntheticLMStream, start_step: int,
                 prefetch: int = 2):
        self.stream = stream
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self.q.put(self.stream.batch_at(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        return self.q.get()

    def stop(self):
        self._stop.set()


def make_stream(cfg: DataConfig, start_step: int = 0,
                prefetch: int = 2) -> _Prefetcher:
    return _Prefetcher(SyntheticLMStream(cfg), start_step, prefetch)
