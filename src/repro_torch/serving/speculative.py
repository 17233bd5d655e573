"""Accept-prefix rule of greedy draft-and-verify speculative decoding
(counterpart of ``repro.serving.speculative``).

Numpy only (neither torch nor jax), so the acceptance rule the engine's
correctness rides on is testable without a model.

Before a speculative dispatch, slot b's cache holds its committed stream
minus the last token, and ``t0 = last_tok`` is the pending input.  The
drafter proposes ``d_1..d_k``; the verifier consumes ``[t0, d_1, .., d_k]``
in ONE ragged step and returns the per-position argmax ``v_0..v_k``
(``v_i`` = the target model's next token after ``t0, d_1..d_i``).  Let
``a`` be the longest prefix with ``d_i == v_{i-1}`` for all ``i <= a``.
Then ``v_0..v_{a-1}`` are exactly the tokens greedy decode would have
emitted, and ``v_a`` is one more greedy token (the bonus token when every
draft hit, the correction when one missed).  So every dispatch commits
``m = a + 1 >= 1`` tokens and the output is token-identical to plain
greedy decode: speculation changes throughput, never content.

Termination folds in as on the plain path: the committed run is cut at
the slot's remaining-token allowance and truncated INCLUSIVELY at its
first EOS (the stream keeps the EOS, as ``Scheduler.commit`` does).  The
verify step advanced the cache by the full ``n_new = k + 1`` rows; the
engine rolls the rejected suffix back by shrinking ``len`` by
``n_new - m`` (sound when ``SlotState.supports_rollback()``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def accept_drafts(drafts: np.ndarray, verify: np.ndarray,
                  n_new: np.ndarray, remaining: np.ndarray,
                  eos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Fold one draft-and-verify dispatch into per-slot token runs.

    ``drafts`` [B, K]: proposed tokens d_1..d_k (entries past a slot's
    own draft count are ignored; -1 rows for idle slots are fine).
    ``verify`` [B, K+1]: per-position verifier argmax v_0..v_k (garbage
    past ``n_new`` — masked here, never read).
    ``n_new`` [B]: rows the verify step consumed per slot (k_b + 1 for
    an active slot with k_b drafts, 0 for an idle slot).
    ``remaining`` [B]: tokens the slot may still emit (>= 1 if active).
    ``eos`` [B]: per-slot EOS id, -1 when EOS termination is disabled.

    Returns ``(emitted [B, K+1], m [B])``: slot b commits
    ``emitted[b, :m[b]]`` (rows padded with -1 past ``m``); ``m`` is 0
    for idle slots and >= 1 for active ones (a missed first draft still
    commits the correction token v_0).
    """
    drafts = np.asarray(drafts, np.int64)
    verify = np.asarray(verify, np.int64)
    n_new = np.asarray(n_new, np.int64)
    B, C = verify.shape
    if drafts.shape != (B, C - 1):
        raise ValueError(
            f"drafts must be [B, K] = [{B}, {C - 1}] for verify "
            f"[B, K+1] = {verify.shape}; got {drafts.shape}")
    emitted = np.full((B, C), -1, np.int64)
    m = np.zeros((B,), np.int64)
    for b in range(B):
        k = int(n_new[b]) - 1
        if k < 0:
            continue  # idle slot: nothing consumed, nothing committed
        a = 0
        while a < k and drafts[b, a] == verify[b, a]:
            a += 1
        # remaining caps the run exactly where per-step decode would have
        # stopped; EOS truncates INCLUSIVELY (the stream keeps the EOS)
        run = verify[b, :a + 1][:max(int(remaining[b]), 0)]
        if eos[b] >= 0:
            hits = np.flatnonzero(run == eos[b])
            if hits.size:
                run = run[:int(hits[0]) + 1]
        m[b] = run.shape[0]
        emitted[b, :run.shape[0]] = run
    return emitted.astype(np.int64), m


def rollback_counts(n_new: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Cache rows to un-advance per slot after committing ``m`` of the
    ``n_new`` verified rows: the verify step inserted rows for
    ``t0, d_1..d_k`` but the committed stream re-feeds its own last
    token next dispatch, so exactly ``m`` of those rows stay valid
    (``t0`` plus the accepted drafts ``d_1..d_{m-1}``) and
    ``n_new - m`` roll back.  Always >= 0: ``m <= n_new`` by
    construction of :func:`accept_drafts`."""
    rb = np.asarray(n_new, np.int64) - np.asarray(m, np.int64)
    if (rb < 0).any():
        raise ValueError(f"committed more rows than verified: {rb}")
    return rb
