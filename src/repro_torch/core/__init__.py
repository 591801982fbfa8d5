"""Pilot-Edge core: the paper's contribution as a composable framework
layer, ported beside ``repro.core``.

Public API (Listing 1 & 2 of the paper):

* :class:`PilotManager` / :class:`ComputeResource` / :class:`Pilot` —
  resource acquisition (step 1),
* :class:`ContinuumPipeline` / :class:`StageSpec` — N-stage FaaS dataflow
  along the continuum; :class:`EdgeToCloudPipeline` — the paper's
  Listing-2 two-stage wrapper (step 2),
* :class:`Broker` / :class:`WanShaper` — pilot-managed brokering,
* :class:`ParameterService` — cross-continuum model sharing,
* :class:`PlacementEngine` / :class:`TaskProfile` — placement trade-offs,
* :class:`MetricsRegistry` — linked cross-component monitoring (step 3),
* :class:`TaskRuntime` — per-pilot execution with retries/stragglers,
* :class:`AutoScaler` / :func:`remesh_restart` — dynamism + fault tolerance.
"""
from repro_torch.core.broker import (Broker, ConsumerGroup, Message, Topic,
                                     WanShaper)
from repro_torch.core.elastic import AutoScaler, ScalePolicy, remesh_restart
from repro_torch.core.executor import (Poll, Service, SimExecutor, Sleep,
                                       ThreadedExecutor)
from repro_torch.core.faas import (ContinuumPipeline, EdgeToCloudPipeline,
                                   PipelineResult, StageSpec)
from repro_torch.core.monitoring import MetricsRegistry
from repro_torch.core.params_service import ParameterService
from repro_torch.core.pilot import (ComputeResource, DeviceMesh, Pilot,
                                    PilotError, PilotManager,
                                    register_backend)
from repro_torch.core.placement import (LinkModel, PlacementDecision,
                                        PlacementEngine, TaskProfile)
from repro_torch.core.runtime import (TaskContext, TaskFailed, TaskFuture,
                                      TaskRuntime)
from repro_torch.sim.clock import SimClock, SystemClock, as_clock

__all__ = [
    "SimClock", "SystemClock", "as_clock",
    "ThreadedExecutor", "SimExecutor", "Poll", "Service", "Sleep",
    "Broker", "ConsumerGroup", "Message", "Topic", "WanShaper",
    "AutoScaler", "ScalePolicy", "remesh_restart",
    "ContinuumPipeline", "StageSpec", "EdgeToCloudPipeline",
    "PipelineResult",
    "MetricsRegistry", "ParameterService",
    "ComputeResource", "DeviceMesh", "Pilot", "PilotError", "PilotManager",
    "register_backend",
    "LinkModel", "PlacementDecision", "PlacementEngine", "TaskProfile",
    "TaskContext", "TaskFailed", "TaskFuture", "TaskRuntime",
]
