"""Multi-tenant streaming equalizer serving runtime, in PyTorch.

Layers (port of `repro.serve`; the threaded runtime, the fleet and the load
generator come with later slices and are not imported here):
  chunker    — stateful overlap-save: arbitrary chunk sizes, offline-exact
  pool       — LRU-bounded engine pool
  session    — TenantSpec / Session / SessionManager
  scheduler  — BatchPolicy / MicroBatcher: dynamic micro-batching into
               stacked fused-kernel launches with per-row tenant weights
  recovery   — fault taxonomy, FaultPlan chaos injection, output sentinel
  runtime    — ServeRuntime (sync)
"""
from .chunker import CarrySnapshot, ChunkPlan, StreamChunker
from .pool import EnginePool
from .recovery import (CorruptOutput, DegradationController, DeviceLost,
                       Fault, FaultPlan, InjectedFault, LaunchTimeout,
                       RecoveryPolicy, RecoveryStats, TenantShedError)
from .runtime import ServeRuntime
from .scheduler import (BatchPolicy, LaunchBatch, MicroBatcher, Request,
                        TrafficStats)
from .session import Session, SessionManager, TenantSpec

__all__ = ["BatchPolicy", "CarrySnapshot", "ChunkPlan", "CorruptOutput",
           "DegradationController", "DeviceLost", "EnginePool", "Fault",
           "FaultPlan", "InjectedFault", "LaunchBatch", "LaunchTimeout",
           "MicroBatcher", "RecoveryPolicy", "RecoveryStats", "Request",
           "ServeRuntime", "Session", "SessionManager", "StreamChunker",
           "TenantShedError", "TenantSpec", "TrafficStats"]
