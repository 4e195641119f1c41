"""The ONE fs-primitive layer of the port's durability plane (copy of
jubatus_tpu/durability/fsio.py) — every fsync, journal append write and
durable rename in the process goes through here.  Centralizing the
syscalls is what makes disk faults injectable: a FaultInjector
installed in-process (tests) or via JUBATUS_FSFAULTS (spawned drill
servers) makes the *real* code paths observe EIO out of fsync, ENOSPC
out of a journal append, or a torn partial write — and the fail-stop
reaction in journal.py is exactly what a real dying disk gets.

Fault spec (JUBATUS_FSFAULTS, or parse_spec() in-process):

  op=ERRNO[@after][xcount][~match][%torn] [; more entries]

  op      fsync | write | replace | open   (which primitive fails)
  ERRNO   EIO | ENOSPC | ...               (errno name raised)
  @after  1-based hit index at which the entry starts firing (default 1)
  xcount  how many hits fire before the entry disarms (default: forever;
          a finite count models "space returns" for ENOSPC recovery)
  ~match  path substring filter (e.g. ~journal- faults only WAL files)
  %torn   on `write`: write only a prefix of the data before raising —
          the torn tail a real ENOSPC/power-cut leaves (default off)

  JUBATUS_FSFAULTS="fsync=EIO@3~journal-"     third WAL fsync dies
  JUBATUS_FSFAULTS="write=ENOSPC x5 %torn"    5 torn ENOSPC appends,
                                              then the disk "has space"

Faults raise through the SAME OSError surface the kernel uses, so
nothing downstream can tell injection from hardware.  Every fired fault
counts `chaos_fault_injected_total.<op>_<errno>` in the metrics
registry, so a drill's injected disk load is visible in get_status next
to the journal_stall counters it provoked.

Determinism: injection is hit-counted, not probabilistic — the Nth
matching call fails no matter how threads interleave, which is what lets
a seeded drill replay bit-identically.

The JAX package's lock-order monitor hook (analysis/lockgraph: every
fsync noted as blocking) is left out; the port has no lock-order plane
yet.
"""

from __future__ import annotations

import errno as _errno
import logging
import os
import threading
from dataclasses import dataclass, field
from typing import BinaryIO, List, Optional

from jubatus_tpu_torch.analysis.lockgraph import MONITOR as _lock_monitor
from jubatus_tpu_torch.utils import metrics as _metrics

log = logging.getLogger("jubatus_tpu_torch.durability")

OPS = ("fsync", "write", "replace", "open")


@dataclass
class FsFault:
    """One armed fault entry; hit accounting is per-entry."""
    op: str
    err: int                  # errno value raised
    after: int = 1            # 1-based matching-hit index that arms it
    count: int = -1           # fires this many times, then disarms (-1 = forever)
    match: str = ""           # path substring filter
    torn: bool = False        # write op: leave a partial prefix behind
    hits: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def matches(self, op: str, path: str) -> bool:
        return self.op == op and (not self.match or self.match in path)

    def take(self) -> bool:
        """Account one matching hit; True when this hit must fail."""
        self.hits += 1
        if self.hits < self.after:
            return False
        if self.count >= 0 and self.fired >= self.count:
            return False
        self.fired += 1
        return True


class FaultInjector:
    """Thread-safe set of FsFault entries consulted by the primitives."""

    def __init__(self, faults: List[FsFault]):
        self._lock = threading.Lock()
        self.faults = faults

    def check(self, op: str, path: str) -> Optional[FsFault]:
        """The armed fault for this call, or None.  The caller raises —
        the injector only accounts, so `write` can shear a torn prefix
        before surfacing the error."""
        with self._lock:
            for f in self.faults:
                if f.matches(op, path) and f.take():
                    kind = f"{op}_{_errname(f.err).lower()}"
                    _metrics.GLOBAL.inc(f"chaos_fault_injected_total.{kind}")
                    log.warning("fsio: injected %s on %s(%s)",
                                _errname(f.err), op, path)
                    return f
        return None


def _errname(err: int) -> str:
    return _errno.errorcode.get(err, str(err))


def parse_spec(spec: str) -> Optional[FaultInjector]:
    """Parse a JUBATUS_FSFAULTS spec; '' -> None.  Malformed entries
    raise ValueError — a typo'd fault silently not armed would let a
    drill pass vacuously."""
    spec = spec.strip()
    if not spec:
        return None
    faults: List[FsFault] = []
    for entry in filter(None, (e.strip() for e in spec.split(";"))):
        op, _, rhs = entry.partition("=")
        op = op.strip()
        if op not in OPS:
            raise ValueError(f"unknown fsio op {op!r} (want {'|'.join(OPS)})")
        # rhs: ERRNO with optional @after xcount ~match %torn markers
        torn = False
        after, count, match = 1, -1, ""
        # tokenize on the marker characters, keeping order-insensitive
        token = ""
        markers: List[str] = []
        for ch in rhs:
            if ch in "@x~%":
                markers.append(token)
                token = ch
            else:
                token += ch
        markers.append(token)
        errname = markers[0].strip().upper()
        err = getattr(_errno, errname, None)
        if not isinstance(err, int):
            raise ValueError(f"unknown errno {errname!r} in {entry!r}")
        for m in markers[1:]:
            m = m.strip()
            if not m:
                continue
            if m[0] == "@":
                after = int(m[1:])
            elif m[0] == "x":
                count = int(m[1:])
            elif m[0] == "~":
                match = m[1:].strip()
            elif m[0] == "%":
                if m[1:].strip() not in ("torn", ""):
                    raise ValueError(f"unknown %marker in {entry!r}")
                torn = True
        faults.append(FsFault(op=op, err=err, after=max(1, after),
                              count=count, match=match, torn=torn))
    return FaultInjector(faults)


_injector: Optional[FaultInjector] = None
_parsed = False
_parse_lock = threading.Lock()


def injector() -> Optional[FaultInjector]:
    """The process FaultInjector: an install()ed one wins, else the
    JUBATUS_FSFAULTS env spec parsed once (None when unset/malformed —
    malformed logs loudly and disables, mirroring utils chaos policy)."""
    global _injector, _parsed
    if _parsed:
        return _injector
    with _parse_lock:
        if not _parsed:
            _parsed = True
            spec = os.environ.get("JUBATUS_FSFAULTS", "")
            if spec:
                try:
                    _injector = parse_spec(spec)
                except ValueError:
                    log.error("malformed JUBATUS_FSFAULTS spec %r (want "
                              "'op=ERRNO[@after][xN][~match][%%torn];...'); "
                              "disk-fault injection DISABLED", spec)
                    _injector = None
    return _injector


def install(inj: Optional[FaultInjector]) -> None:
    """Install (or clear, with None) the process fault injector at
    runtime — in-process tests use this."""
    global _injector, _parsed
    with _parse_lock:
        _injector = inj
        _parsed = True


def reset_for_tests() -> None:
    global _injector, _parsed
    with _parse_lock:
        _injector = None
        _parsed = False


def _check(op: str, path: str) -> Optional[FsFault]:
    inj = injector()
    return inj.check(op, path) if inj is not None else None


def _raise(f: FsFault, op: str, path: str) -> None:
    raise OSError(f.err, f"{os.strerror(f.err)} [injected:{op}]", path)


# -- primitives --------------------------------------------------------------
# These are the ONLY call sites of os.fsync / os.replace in the port.
# They deliberately do nothing clever: wrap the syscall, consult the
# injector, report the blocking call to the lock-order detector.

def fsync_file(fp: BinaryIO, *, path: str = "") -> None:
    """Flush Python buffers and force the file's bytes to stable
    storage.  Raises the injected (or real) OSError WITHOUT retrying:
    after a failed fsync the kernel may have dropped the dirty pages and
    cleared the error — a retry "succeeds" while the data is gone, so
    the caller must fail-stop, never loop (journal.py stall semantics)."""
    _lock_monitor.note_blocking("fsync_file")   # never under the write lock
    fp.flush()
    p = path or getattr(fp, "name", "") or ""
    f = _check("fsync", p)
    if f is not None:
        _raise(f, "fsync", p)
    os.fsync(fp.fileno())


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a rename/create inside it survives a host
    crash (os.replace alone only orders the data, not the dir entry)."""
    _lock_monitor.note_blocking("fsync_dir")
    f = _check("fsync", path)
    if f is not None:
        _raise(f, "fsync", path)
    fd = os.open(path or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def open_append(path: str) -> BinaryIO:
    """Open a journal segment for appending, UNBUFFERED: every append is
    one write(2), so an ENOSPC/short write surfaces at the exact frame
    that failed (with a buffered fp the error fires at some later flush,
    long after the append was acked upstream) and the journal knows the
    precise good-bytes boundary to truncate back to."""
    f = _check("open", path)
    if f is not None:
        _raise(f, "open", path)
    return open(path, "ab", buffering=0)


def append_bytes(fp: BinaryIO, data: bytes, *, path: str = "") -> None:
    """Write all of `data` to an unbuffered append fp.  An injected
    torn fault writes a genuine partial prefix first — the on-disk state
    a real ENOSPC leaves — then raises; a real short write loops like
    every correct raw-write must."""
    p = path or getattr(fp, "name", "") or ""
    f = _check("write", p)
    if f is not None:
        if f.torn and len(data) > 1:
            try:
                fp.write(data[:1 + (f.hits % max(1, len(data) - 1))])
            except OSError:
                pass
            else:
                try:
                    fp.flush()
                except OSError:
                    pass
        _raise(f, "write", p)
    view = memoryview(data)
    written = 0
    while written < len(data):
        n = fp.write(view[written:])
        if n is None:       # buffered fp: whole buffer accepted
            break
        written += n


def replace(src: str, dst: str) -> None:
    """Atomic rename (os.replace) behind the injector — the snapshot
    publish step's failure point."""
    f = _check("replace", dst)
    if f is not None:
        _raise(f, "replace", dst)
    os.replace(src, dst)
