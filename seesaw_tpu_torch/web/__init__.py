"""Web serving layer: HTTP API and per-session state, on an explicit device.

Counterpart of `seesaw_tpu/web`: the same endpoint set and wire schemas
(the same frontend talks to either server), a dependency-free threaded
stdlib HTTP server, in-process sessions with per-session locks, and request
coalescing (`coalesce`) for sessions that share an index.
"""

from .common import AppState, SessionReq, ResetReq, Worker, g_queries  # noqa: F401
from .session_manager import SessionManager, WebSession  # noqa: F401
from .app import SeesawServer  # noqa: F401
