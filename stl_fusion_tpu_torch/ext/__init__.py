"""Extension services (SURVEY.md §2.8): time, KV store, auth, sessions,
peer monitoring."""
from .auth import (
    EditUserCommand,
    InMemoryAuthService,
    SessionInfo,
    SetupSessionCommand,
    SignInCommand,
    SignOutCommand,
    SqliteAuthService,
    User,
)
from .server_auth import Principal, ServerAuthHelper, principal_from_headers
from .fusion_time import FusionTime
from .kv_store import (
    KeyValueStore,
    RemoveCommand,
    SandboxedKeyValueStore,
    SetCommand,
    SqliteKeyValueStore,
)
from .multitenancy import (
    PerTenantWorkerHost,
    Tenant,
    TenantNotFoundError,
    TenantRegistry,
    TenantResolver,
)
from .peer_monitor import RpcPeerState, RpcPeerStateMonitor
from .plugins import PluginHost, PluginInfo, PluginSetInfo, find_plugins, plugin
from .session import Session, SessionResolver
from .streams import (
    BrokerChangeNotifier,
    InMemoryBroker,
    MessageBroker,
    PubSub,
    SequenceSet,
    Streamer,
    TypedQueue,
)

__all__ = [
    "EditUserCommand",
    "InMemoryAuthService",
    "Principal",
    "ServerAuthHelper",
    "SessionInfo",
    "SetupSessionCommand",
    "SignInCommand",
    "SignOutCommand",
    "User",
    "principal_from_headers",
    "FusionTime",
    "KeyValueStore",
    "RemoveCommand",
    "SandboxedKeyValueStore",
    "SetCommand",
    "SqliteAuthService",
    "SqliteKeyValueStore",
    "PerTenantWorkerHost",
    "Tenant",
    "TenantNotFoundError",
    "TenantRegistry",
    "TenantResolver",
    "RpcPeerState",
    "RpcPeerStateMonitor",
    "Session",
    "SessionResolver",
    "PluginHost",
    "PluginInfo",
    "PluginSetInfo",
    "find_plugins",
    "plugin",
    "BrokerChangeNotifier",
    "InMemoryBroker",
    "MessageBroker",
    "PubSub",
    "SequenceSet",
    "Streamer",
    "TypedQueue",
]
