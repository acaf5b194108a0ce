"""TP divisibility resolution (head padding / KV replication).

Port of `repro.parallel.sharding.resolve_heads` and `kv_head_map`, which
are pure Python. The rest of that module (meshes, logical axis rules,
param specs) has no counterpart yet: on one card ``tp = 1`` and its
`logical` annotations are no-ops, so the port's models drop them.
"""
from __future__ import annotations

import numpy as np


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def resolve_heads(n_heads: int, n_kv: int, tp: int):
    """(padded_q_heads, effective_kv_heads) for TP degree `tp`.

    Two schemes are compared and the cheaper one (fewest Q heads, then
    fewest KV replicas) is chosen:

    * **Group padding (A)**: pad each GQA group to a common size q' so that
      hq = n_kv·q' is a multiple of tp; KV heads are replicated by the
      smallest factor r | q' such that n_kv·r divides by tp.
    * **Full expansion (B)**: hq = round_up(n_heads, tp), one kv replica per
      q head.
    """
    if tp <= 1:
        return n_heads, n_kv
    q_per = -(-n_heads // n_kv)
    qa = q_per
    while (n_kv * qa) % tp:
        qa += 1
    hq_a = n_kv * qa
    r_a = next(r for r in range(1, qa + 1)
               if qa % r == 0 and (n_kv * r) % tp == 0)
    kv_a = n_kv * r_a
    hq_b = _round_up(n_heads, tp)
    kv_b = hq_b
    if (hq_a, kv_a) <= (hq_b, kv_b):
        return hq_a, kv_a
    return hq_b, kv_b


def kv_head_map(n_heads: int, n_kv: int, hq: int, kv_eff: int) -> np.ndarray:
    """Original kv-head index serving each *expanded* kv slot.

    Scheme A (hq % n_kv == 0, kv_eff % n_kv == 0): slot j → j // r.
    Scheme B (kv_eff == hq): slot j (== q slot) → original GQA assignment.
    """
    if hq % n_kv == 0 and kv_eff % n_kv == 0 and kv_eff < hq:
        r = kv_eff // n_kv
        return np.asarray([j // r for j in range(kv_eff)], dtype=np.int32)
    base = [(i * n_kv) // n_heads for i in range(n_heads)]
    base += [base[-1]] * (kv_eff - n_heads)      # padded heads reuse the last
    return np.asarray(base, dtype=np.int32)
