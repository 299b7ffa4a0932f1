"""UI layer (SURVEY.md §2.7): live components + action tracking + browser push."""
from .action_tracker import UIActionFailureTracker, UIActionTracker, UICommander
from .auth_state import AuthState, AuthStateProvider
from .live_component import LiveComponent, MixedStateComponent
from .web import HtmlComponent, LiveViewServer

__all__ = [
    "UIActionTracker",
    "UIActionFailureTracker",
    "UICommander",
    "AuthState",
    "AuthStateProvider",
    "LiveComponent",
    "MixedStateComponent",
    "HtmlComponent",
    "LiveViewServer",
]
