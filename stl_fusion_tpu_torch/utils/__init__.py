"""L0 substrate: results, versions, clocks, async primitives, timers,
collections, caches, requirements and wire serialization (pure Python)."""
from .async_chain import AsyncChain, RetryDelaySeq, WorkerBase
from .async_utils import (
    AsyncEvent,
    AsyncLockSet,
    Channel,
    ChannelClosedError,
    ChannelPair,
    LockReentryError,
    create_twisted_pair,
)
from .caching import ComputingCache, FastComputingCache, FileSystemCache
from .collections import OptionSet, RecentlySeenMap
from .concurrency import StochasticCounter
from .errors import ExceptionInfo, RemoteError, ServiceError, TransientError, register_exception_type
from .ltag import ClockBasedVersionGenerator, LTag, LTagVersionGenerator, VersionGenerator
from .moment import CpuClock, Moment, MomentClock, MomentClockSet, SystemClock, TestClock
from .result import Result, error, ok
from .requirements import MUST_EXIST, Requirement, RequirementError, must_exist
from .serialization import (
    WireSerializer,
    decode,
    deep_tuple,
    dumps,
    encode,
    loads,
    register_wire_type,
    wire_type,
)
from .text import Symbol
from .timer_set import ConcurrentTimerSet

__all__ = [
    "AsyncChain", "RetryDelaySeq", "WorkerBase",
    "AsyncEvent", "AsyncLockSet", "Channel", "ChannelClosedError", "ChannelPair",
    "LockReentryError", "create_twisted_pair",
    "OptionSet", "RecentlySeenMap",
    "ComputingCache", "FastComputingCache", "FileSystemCache", "StochasticCounter",
    "MUST_EXIST", "Requirement", "RequirementError", "must_exist", "Symbol",
    "ExceptionInfo", "RemoteError", "ServiceError", "TransientError", "register_exception_type",
    "ClockBasedVersionGenerator", "LTag", "LTagVersionGenerator", "VersionGenerator",
    "CpuClock", "Moment", "MomentClock", "MomentClockSet", "SystemClock", "TestClock",
    "Result", "error", "ok",
    "WireSerializer", "decode", "deep_tuple", "dumps", "encode", "loads",
    "register_wire_type", "wire_type",
    "ConcurrentTimerSet",
]
