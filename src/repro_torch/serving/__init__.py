"""Serving over the COW-paged KV cache: the cache, the batched decode
engine, population-based SMC decoding, the continuous-batching scheduler
and the fault injection / recovery layer (the router, the traces and the
scheduler simulator are still to port: ROADMAP.md queue 1, item 2)."""

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
from repro_torch.serving.smc_decode import SMCDecoder

__all__ = [
    "AdmissionRefused",
    "AllReplicasSaturated",
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
    "PREEMPT_POLICIES",
    "PagedKVCache",
    "PreemptPolicy",
    "RequestStatus",
    "RetryPolicy",
    "Scheduler",
    "SchedulerEventLog",
    "ServeEngine",
    "SlaAware",
    "SlotTable",
    "SMCDecoder",
    "TokenEvent",
    "TUNED_DEFAULTS",
    "TransientStepFailure",
    "chaos_schedule",
    "load_checkpoint",
    "resolve_preempt_policy",
    "save_checkpoint",
    "stream_tokens",
]
