"""Process logger with the SIGHUP reopen (the port's copy of
jubatus_tpu/utils/logger.py).

stdlib logging with a re-openable file handler, so external log rotation
(logrotate's mv, then SIGHUP through utils/signals.py) works without a
restart; `--log_format json` emits one JSON object a record with the
active trace and span ids of the tracer (obs/trace.py), so slow-op lines
and ordinary logs of one request join on one key.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
from typing import Optional

_state = {"configured": False, "handler": None, "path": None, "fmt": "plain"}
_lock = threading.Lock()

FORMAT = "%(asctime)s %(levelname)s %(process)d %(threadName)s %(name)s: %(message)s"


class JsonFormatter(logging.Formatter):
    """`--log_format json`: one JSON object per record, with the active
    trace/span id injected from the tracing plane's context — so slow-op
    lines (which carry their trace_id in the payload) and ordinary logs
    emitted while serving the same request join on one key."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": self.formatTime(record),
            "level": record.levelname,
            "logger": record.name,
            "pid": record.process,
            "thread": record.threadName,
            "msg": record.getMessage(),
        }
        try:
            from jubatus_tpu_torch.obs.trace import TRACER
            span = TRACER.current()
            if span is not None and span:
                out["trace_id"] = span.trace_id
                out["span_id"] = span.span_id
        except Exception:   # the tracing plane must never break logging
            pass
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class ReopenableFileHandler(logging.FileHandler):
    """FileHandler whose underlying file can be re-opened in place —
    the SIGHUP rotation contract."""

    def reopen(self) -> None:
        with self.lock:
            self.close()
            self._closed = False
            self.stream = self._open()


def configure(logfile: Optional[str] = None, level: str = "info",
              fmt: str = "plain") -> None:
    """Configure the root logger: stderr, or an appendable logfile.
    `fmt='json'` swaps in the structured JsonFormatter (trace-id
    injection); 'plain' keeps the classic line format."""
    with _lock:
        root = logging.getLogger()
        root.setLevel(getattr(logging, level.upper(), logging.INFO))
        old = _state["handler"]
        if old is not None:
            root.removeHandler(old)
            old.close()
        if logfile:
            handler: logging.Handler = ReopenableFileHandler(logfile)
        else:
            handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(JsonFormatter() if fmt == "json"
                             else logging.Formatter(FORMAT))
        root.addHandler(handler)
        _state["handler"] = handler
        _state["path"] = logfile
        _state["fmt"] = fmt
        _state["configured"] = True
    # background-thread crashes (snapshotter, ingest pipeline, exporter)
    # must emit one structured ERROR + thread_crash_total, never die
    # silently to a bare stderr traceback
    install_thread_excepthook()


def install_thread_excepthook() -> None:
    """Route background-thread crashes through structured logging.

    The serving stack runs a dozen daemon threads (snapshotter, journal
    fsync timer, ingest convert/dispatch, mixer, exporter...).  The
    stdlib default prints a raw traceback to stderr, invisible to log
    pipelines and uncounted, so a dead snapshot timer looks like a
    healthy idle one.  This hook emits ONE structured JSON ERROR
    line per crash plus the `thread_crash_total` counter, so thread
    deaths land on /metrics and in the log stream.  Idempotent;
    configure() installs it, tests may call it directly."""
    import threading
    if getattr(threading.excepthook, "_jubatus_hook", False):
        return

    def hook(args, _log=logging.getLogger("jubatus_tpu_torch.thread")):
        if args.exc_type is SystemExit:
            return              # stdlib semantics: silent thread exit
        try:
            from jubatus_tpu_torch.utils.metrics import GLOBAL as _metrics
            _metrics.inc("thread_crash_total")
        except Exception:  # the registry must never break crash logging
            logging.getLogger(__name__).debug(
                "thread_crash_total unavailable", exc_info=True)
        import traceback
        thread = getattr(args, "thread", None)
        _log.error("thread_crash %s", json.dumps({
            "thread": thread.name if thread is not None else "?",
            "exc_type": getattr(args.exc_type, "__name__",
                                str(args.exc_type)),
            "exc": str(args.exc_value),
            "traceback": "".join(traceback.format_exception(
                args.exc_type, args.exc_value, args.exc_traceback)),
        }, default=str))

    hook._jubatus_hook = True
    threading.excepthook = hook


def is_configured() -> bool:
    return bool(_state["configured"])


def reopen() -> bool:
    """Re-open the log file (SIGHUP action).  No-op for stderr logging."""
    with _lock:
        h = _state["handler"]
        if isinstance(h, ReopenableFileHandler):
            h.reopen()
            logging.getLogger(__name__).info("log file reopened")
            return True
        return False
