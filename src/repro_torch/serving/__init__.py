"""Serving over the COW-paged KV cache: the cache, the batched decode
engine, population-based SMC decoding, the continuous-batching scheduler,
the fault injection / recovery layer, seeded arrival traces, the
device-free scheduler simulator and the replicated-fleet router."""

from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.faults import (
    AllReplicasSaturated,
    DeviceLost,
    FaultEvent,
    FaultInjector,
    FaultKind,
    FaultRetriesExhausted,
    InvariantViolation,
    RequestStatus,
    RetryPolicy,
    TransientStepFailure,
    chaos_schedule,
)
from repro_torch.serving.kv_cache import KVCacheConfig, PagedKVCache
from repro_torch.serving.router import (
    PLACEMENT_POLICIES,
    Replica,
    Router,
    RouterEventLog,
    make_replicas,
)
from repro_torch.serving.scheduler import (
    PREEMPT_POLICIES,
    TUNED_DEFAULTS,
    AdmissionRefused,
    DecodeRequest,
    LongestWait,
    NewestFirst,
    PreemptPolicy,
    Scheduler,
    SchedulerEventLog,
    SlaAware,
    SlotTable,
    TokenEvent,
    load_checkpoint,
    resolve_preempt_policy,
    save_checkpoint,
    stream_tokens,
)
from repro_torch.serving.sim import (
    CostModel,
    SimScheduler,
    simulate,
    simulate_router,
)
from repro_torch.serving.smc_decode import SMCDecoder
from repro_torch.serving.traces import Trace, TraceRequest

__all__ = [
    "AdmissionRefused",
    "AllReplicasSaturated",
    "CostModel",
    "DecodeRequest",
    "DeviceLost",
    "FaultEvent",
    "FaultInjector",
    "FaultKind",
    "FaultRetriesExhausted",
    "InvariantViolation",
    "KVCacheConfig",
    "LongestWait",
    "NewestFirst",
    "PLACEMENT_POLICIES",
    "PREEMPT_POLICIES",
    "PagedKVCache",
    "PreemptPolicy",
    "Replica",
    "RequestStatus",
    "RetryPolicy",
    "Router",
    "RouterEventLog",
    "Scheduler",
    "SchedulerEventLog",
    "ServeEngine",
    "SimScheduler",
    "SlaAware",
    "SlotTable",
    "SMCDecoder",
    "TokenEvent",
    "TUNED_DEFAULTS",
    "Trace",
    "TraceRequest",
    "TransientStepFailure",
    "chaos_schedule",
    "load_checkpoint",
    "make_replicas",
    "resolve_preempt_policy",
    "save_checkpoint",
    "simulate",
    "simulate_router",
    "stream_tokens",
]
