"""Signal-driven lifecycle actions (the port's copy of
jubatus_tpu/utils/signals.py): a registry of actions a signal, installed
once.  SIGTERM/SIGINT drive the graceful stop (and the --torch_profile
export), SIGHUP the log reopen.  Python delivers signals on the main
thread, so the actions run there.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Dict, List

_actions: Dict[int, List[Callable[[], None]]] = {}
_installed: Dict[int, bool] = {}
_lock = threading.Lock()


def _dispatch(signum, frame):
    for fn in list(_actions.get(signum, [])):
        try:
            fn()
        except Exception:
            import logging
            logging.getLogger(__name__).exception(
                "signal action failed for %d", signum)


def _register(signum: int, fn: Callable[[], None]) -> None:
    with _lock:
        _actions.setdefault(signum, []).append(fn)
        if not _installed.get(signum):
            signal.signal(signum, _dispatch)
            _installed[signum] = True


def set_action_on_term(fn: Callable[[], None]) -> None:
    """Run fn on SIGTERM/SIGINT (graceful shutdown)."""
    _register(signal.SIGTERM, fn)
    _register(signal.SIGINT, fn)


def set_action_on_hup(fn: Callable[[], None]) -> None:
    """Run fn on SIGHUP (log reopen)."""
    _register(signal.SIGHUP, fn)


def clear_actions() -> None:
    """Testing hook: drop all registered actions (handlers stay installed)."""
    with _lock:
        _actions.clear()
