"""Online adaptation runtime — per-tenant background fine-tuning with
BER-gated weight hot-swap under channel drift, in PyTorch.

Port of `repro.adapt` (see docs/ADAPTATION.md). Layers:
  collector — `Session.tap`-driven ring of served (rx, label) pairs
              (pilot or decision-directed labels)
  trainer   — weight-only QAT resume over the buffer (formats frozen, so
              the deployed backend can never change mid-flight)
  shadow    — candidate-vs-active BER on held-out traffic; hysteresis-
              guarded promotion and rollback decisions
  runtime   — `OnlineAdapter`: the collect → fine-tune → shadow-eval →
              promote/rollback control loop over a serving runtime,
              synchronous (`step()`) or as a background thread
"""
from .collector import SampleCollector, hard_decide, pam_amplitudes
from .runtime import AdaptPolicy, AdaptReport, OnlineAdapter
from .shadow import (PromotionPolicy, ShadowReport, engine_ber,
                     shadow_evaluate)
from .trainer import FineTuneConfig, fine_tune_from_buffer, make_sample_fn

__all__ = ["AdaptPolicy", "AdaptReport", "FineTuneConfig", "OnlineAdapter",
           "PromotionPolicy", "SampleCollector", "ShadowReport",
           "engine_ber", "fine_tune_from_buffer", "hard_decide",
           "make_sample_fn", "pam_amplitudes", "shadow_evaluate"]
