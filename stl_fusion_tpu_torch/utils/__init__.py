"""L0 substrate the computed-graph runtime needs: results, versions,
clocks, async locks, timers and wire-type registration (pure Python)."""
from .async_chain import AsyncChain, RetryDelaySeq, WorkerBase
from .async_utils import AsyncLockSet
from .errors import ExceptionInfo, RemoteError, ServiceError, TransientError
from .ltag import ClockBasedVersionGenerator, LTag, LTagVersionGenerator, VersionGenerator
from .moment import CpuClock, Moment, MomentClock, MomentClockSet, SystemClock, TestClock
from .result import Result, error, ok
from .serialization import deep_tuple, register_wire_type
from .timer_set import ConcurrentTimerSet

__all__ = [
    "AsyncChain", "RetryDelaySeq", "WorkerBase", "AsyncLockSet",
    "ExceptionInfo", "RemoteError", "ServiceError", "TransientError",
    "ClockBasedVersionGenerator", "LTag", "LTagVersionGenerator", "VersionGenerator",
    "CpuClock", "Moment", "MomentClock", "MomentClockSet", "SystemClock", "TestClock",
    "Result", "error", "ok", "deep_tuple", "register_wire_type", "ConcurrentTimerSet",
]
