"""Multi-tenant streaming equalizer serving runtime, in PyTorch.

Layers (port of `repro.serve`; the fleet comes with a later slice and is
not imported here):
  chunker    — stateful overlap-save: arbitrary chunk sizes, offline-exact
  pool       — LRU-bounded engine pool
  session    — TenantSpec / Session / SessionManager
  scheduler  — BatchPolicy / MicroBatcher: dynamic micro-batching into
               stacked fused-kernel launches with per-row tenant weights
  recovery   — fault taxonomy, FaultPlan chaos injection, output sentinel
  runtime    — ServeRuntime (sync) / AsyncServeRuntime (threaded
               front-end: timer-driven pump, double-buffered launches on
               the launcher's CUDA stream, per-chunk futures,
               deadline/backoff launch discipline, bounded session
               failover)
  loadgen    — reproducible tenant traffic (chop, random_waveforms,
               replay)
"""
from .chunker import CarrySnapshot, ChunkPlan, StreamChunker
from .loadgen import chop, random_waveforms, replay
from .pool import EnginePool
from .recovery import (CorruptOutput, DegradationController, DeviceLost,
                       Fault, FaultPlan, InjectedFault, LaunchTimeout,
                       RecoveryPolicy, RecoveryStats, TenantShedError)
from .runtime import AsyncServeRuntime, ServeRuntime
from .scheduler import (BatchPolicy, LaunchBatch, MicroBatcher, Request,
                        TrafficStats)
from .session import Session, SessionManager, TenantSpec

__all__ = ["AsyncServeRuntime", "BatchPolicy", "CarrySnapshot", "ChunkPlan",
           "CorruptOutput", "DegradationController", "DeviceLost",
           "EnginePool", "Fault", "FaultPlan", "InjectedFault", "LaunchBatch",
           "LaunchTimeout", "MicroBatcher", "RecoveryPolicy", "RecoveryStats",
           "Request", "ServeRuntime", "Session", "SessionManager",
           "StreamChunker", "TenantShedError", "TenantSpec", "TrafficStats",
           "chop", "random_waveforms", "replay"]
