"""Shadow evaluation + hysteresis-guarded promotion decisions.

A fine-tuned candidate must EARN its way into the live stream: the shadow
evaluator runs candidate and active engines over the collector's held-out
traffic (data the fine-tuner never saw) and compares BERs against the
buffered labels. Promotion requires a hysteresis-guarded win — a relative
AND absolute BER margin — so label noise and eval variance cannot cause
swap thrash; the same comparison, pointed at the pre-swap engine, decides
rollback when a promotion turns out to have been a mistake.

The engines evaluated here are the REAL deployed artifacts (the candidate
is built through the same pinned-formats `TenantSpec` path the hot-swap
installs), so the decision sees exactly the quantized datapath the stream
would get — including any int8 saturation the fine-tune introduced.

Port of `repro.adapt.shadow`. The engines run on their own device (the
card, or the host with ``device="cpu"``); the scoring is host numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .collector import hard_decide


@dataclasses.dataclass(frozen=True)
class PromotionPolicy:
    """Hysteresis knobs for the promote/rollback decisions.

    min_eval_syms:   refuse to decide on fewer held-out symbols (default
                     2048 — below this, a BER estimate at the interesting
                     1e-2..1e-1 range has too few error events).
    min_rel_gain:    candidate BER must undercut active by this fraction
                     (default 0.15 — the hysteresis band; within it the
                     active weights stay, preventing swap thrash on noise).
    min_abs_gain:    …and by this absolute BER (default 2e-3 — two engines
                     both at ~0 BER never swap).
    eval_bucket_syms: evaluation streams are trimmed to a multiple of this
                     (default 1024) so eval launches reuse a tiny set of
                     launch widths (on the card this bounds how many
                     distinct widths the shadow engines launch at).
    max_eval_syms:   cap on evaluation length (default 8192) — bounds the
                     per-cycle eval cost as the buffer grows.
    """
    min_eval_syms: int = 2048
    min_rel_gain: float = 0.15
    min_abs_gain: float = 2e-3
    eval_bucket_syms: int = 1024
    max_eval_syms: int = 8192


@dataclasses.dataclass
class ShadowReport:
    """Outcome of one candidate-vs-active shadow evaluation."""
    ber_active: float
    ber_candidate: float
    eval_syms: int
    promote: bool
    reason: str


def engine_ber(engine, rx: np.ndarray, syms: np.ndarray) -> float:
    """BER of an `EqualizerEngine` over a labelled waveform.

    Trims to whole engine passes (total_stride samples each); labels are
    whatever the collector stored (pilot or decision-directed), so with
    decision labels this measures DISAGREEMENT with the labelling
    equalizer rather than true BER — still the right promotion signal,
    since both engines are scored against the same labels.
    """
    ts = engine.total_stride
    vp = engine.cfg.v_parallel
    n_pos = int(rx.shape[0]) // ts
    if n_pos == 0:
        return float("nan")
    rx = rx[: n_pos * ts]
    want = np.asarray(syms[: n_pos * vp])
    x = torch.from_numpy(np.array(rx[None], np.float32))
    y = engine(x.to(engine.device))[0].cpu().numpy()
    got = hard_decide(y, engine.cfg.levels)
    return float(np.mean(got != want[: got.shape[0]]))


def _trim(rx: np.ndarray, syms: np.ndarray, n_os: int,
          policy: PromotionPolicy):
    """Apply the eval-length bucket + cap (launch-width hygiene)."""
    n = min(int(syms.shape[0]), int(rx.shape[0]) // n_os,
            policy.max_eval_syms)
    n = (n // policy.eval_bucket_syms) * policy.eval_bucket_syms
    return rx[: n * n_os], syms[:n], n


def shadow_evaluate(active_engine, candidate_engine, rx: np.ndarray,
                    syms: np.ndarray,
                    policy: PromotionPolicy = PromotionPolicy()
                    ) -> ShadowReport:
    """Score candidate vs active on held-out traffic; decide promotion.

    Promotion fires only on a hysteresis-guarded win (see
    `PromotionPolicy`); everything else — insufficient data, a tie, a
    loss — keeps the active weights, with the reason recorded.
    """
    n_os = active_engine.cfg.n_os
    rx, syms, n = _trim(rx, syms, n_os, policy)
    if n < policy.min_eval_syms:
        return ShadowReport(float("nan"), float("nan"), n, False,
                            f"insufficient eval data ({n} syms < "
                            f"{policy.min_eval_syms})")
    ber_a = engine_ber(active_engine, rx, syms)
    ber_c = engine_ber(candidate_engine, rx, syms)
    margin = max(policy.min_rel_gain * ber_a, policy.min_abs_gain)
    if ber_c <= ber_a - margin:
        return ShadowReport(ber_a, ber_c, n, True,
                            f"candidate wins by {ber_a - ber_c:.2e} "
                            f"(margin {margin:.2e})")
    return ShadowReport(ber_a, ber_c, n, False,
                        f"within hysteresis band (active {ber_a:.2e}, "
                        f"candidate {ber_c:.2e}, margin {margin:.2e})")
