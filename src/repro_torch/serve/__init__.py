"""Multi-tenant streaming equalizer serving runtime, in PyTorch.

Layers (port of `repro.serve`):
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
  fleet      — FleetRuntime: N workers (one launcher thread and CUDA
               stream each) behind shard-by-tenant placement, heartbeat
               health and bitwise device-loss migration; also the single
               source of device-set truth (worker_devices / best_mesh)
  loadgen    — reproducible tenant traffic (chop, random_waveforms,
               replay; replay_wire through the net layer; drift_streams
               and replay_adaptive over a drifting channel)
"""
from .chunker import CarrySnapshot, ChunkPlan, StreamChunker
from .fleet import (FleetRuntime, FleetWorker, best_mesh, mesh_shape,
                    worker_devices)
from .loadgen import (chop, drift_streams, random_waveforms, replay,
                      replay_adaptive, replay_wire)
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
           "EnginePool", "Fault", "FaultPlan", "FleetRuntime", "FleetWorker",
           "InjectedFault", "LaunchBatch", "LaunchTimeout", "MicroBatcher",
           "RecoveryPolicy", "RecoveryStats", "Request", "ServeRuntime",
           "Session", "SessionManager", "StreamChunker", "TenantShedError",
           "TenantSpec", "TrafficStats", "best_mesh", "chop",
           "drift_streams", "mesh_shape", "random_waveforms", "replay",
           "replay_adaptive", "replay_wire",
           "worker_devices"]
