"""Synthetic instruction-tuning data pipeline: the port's own copy of
``repro.data.pipeline`` (pure numpy), so the port trains on bit-identical
batches without importing the JAX package.

The paper fine-tunes on Alpaca / FLAN v2 / Self-instruct / Longform /
Chip2.  Offline we reproduce the *shape* of that pipeline with synthetic
instruction tasks, each a dataset-specific first-order Markov chain:
the answer starts from the first prompt token and steps by a per-dataset
stride k (mod the content vocab), so p(next | prev) is exactly learnable
by a small model in a few hundred CPU steps — fine-tuning on a new
"dataset" (unseen stride) yields a large, crisp accuracy delta, which is
what the paper's Table 1/6 axes need at toy scale:

  alpaca   : stride 1     flanv2   : stride 3    selfinst : stride 5
  longform : stride 7 (double-length answer)     chip2    : stride 11

Production properties the trainer relies on:
  * fully deterministic from (seed, step): restart/skip-ahead is O(1) —
    the restore path just sets the step counter (fault tolerance);
  * host-sharded: each data-parallel host draws only its slice;
  * packed: prompt+answer packed to seq_len, prompt positions labeled -1
    (loss-masked), answers supervised.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

TASKS = ("alpaca", "flanv2", "selfinst", "longform", "chip2")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "alpaca"
    vocab: int = 256
    seq_len: int = 64
    global_batch: int = 8
    seed: int = 0
    n_examples: int = 0      # 0 = unbounded stream; >0 = dataset size (epochs wrap)
    host_id: int = 0
    n_hosts: int = 1


STRIDE = {"alpaca": 1, "flanv2": 3, "selfinst": 5, "longform": 7, "chip2": 11}


def _answer(task: str, prompt: np.ndarray, vocab: int) -> np.ndarray:
    k = STRIDE[task]
    n = len(prompt) * (2 if task == "longform" else 1)
    lo = 4  # content tokens start after the reserved ids
    span = vocab - lo
    start = int(prompt[0]) - lo
    return (start + k * np.arange(1, n + 1)) % span + lo


class InstructionStream:
    """Deterministic packed instruction stream; resume = set step."""

    BOS, SEP, EOS = 1, 2, 3
    RESERVED = 4  # content tokens start here

    def __init__(self, cfg: DataConfig):
        assert cfg.dataset in TASKS, cfg.dataset
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.step = 0

    @property
    def local_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.n_hosts

    def skip_to(self, step: int):
        self.step = step

    def _example(self, rng: np.random.Generator):
        cfg = self.cfg
        max_prompt = (cfg.seq_len - 3) // (3 if cfg.dataset == "longform" else 2)
        plen = int(rng.integers(4, max(5, max_prompt)))
        prompt = rng.integers(self.RESERVED, cfg.vocab, size=plen)
        ans = _answer(cfg.dataset, prompt, cfg.vocab)
        toks = np.concatenate([[self.BOS], prompt, [self.SEP], ans, [self.EOS]])
        # labels: next-token targets, supervised only on the answer span
        labels = np.full_like(toks, -1)
        astart = plen + 2  # first answer position
        labels[astart - 1 : astart + len(ans)] = toks[astart : astart + len(ans) + 1]
        return toks[: cfg.seq_len], labels[: cfg.seq_len]

    def _seed_for(self, step: int, row: int) -> int:
        cfg = self.cfg
        global_row = cfg.host_id * self.local_batch + row
        ix = step * cfg.global_batch + global_row
        if cfg.n_examples:
            ix %= cfg.n_examples
        return (cfg.seed * 1_000_003 + ix) & 0x7FFFFFFF

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        toks = np.zeros((self.local_batch, cfg.seq_len), np.int32)
        labs = np.full((self.local_batch, cfg.seq_len), -1, np.int32)
        for r in range(self.local_batch):
            rng = np.random.default_rng(self._seed_for(self.step, r))
            # pack examples until the row is full
            off = 0
            while off < cfg.seq_len - 8:
                t, l = self._example(rng)
                n = min(len(t), cfg.seq_len - off)
                toks[r, off : off + n] = t[:n]
                labs[r, off : off + n] = l[:n]
                off += n
        self.step += 1
        return toks, labs

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_batch()


def make_stream(dataset: str = "alpaca", **kw) -> InstructionStream:
    return InstructionStream(DataConfig(dataset=dataset, **kw))
