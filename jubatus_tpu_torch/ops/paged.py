"""Score sweeps over a spilled PagedRowStore (counterpart of
jubatus_tpu/ops/paged.py): exact whole-table results from the two tiers,
the device pool and the host master.

A sweep is one launch over the resident pool, queued under the store's
spill lock so no later upload overtakes it, then the absent pages in
chunks of SPILL_CHUNK_ROWS rows: each chunk is copied from the pinned
master to the card on a side stream into one of two device buffers, so
the copy of chunk i + 1 overlaps the sweep of chunk i, and swept by the
same kernel.  A chunk whose runs of pages are long is copied run by run
straight from the master (it is pinned, so no host gather is needed);
one of short runs is first gathered into a pinned staging buffer of the
call's own (see RUN_BYTES_MIN).  Each call allocates its own buffers, so two readers under
the model's read lock never share one.  The per-row results land in one
[Nq, capacity] device tensor, copied to the host once.

The kernels are the port's own: K5 in its scores mode (ops/lsh.py
sig_scores, _sig_similarities's float32 score, the JAX package's
_sig_block_scores) and K4 dense_dots (the sparse-row dots, its
_dense_block_dots).  A row's score depends only on the row and the
query, so the chunk width, the port's own constant, changes no score;
page_spill_in_total counts the streamed pages, not chunks, as the JAX
store does.  On the CPU (a store on the CPU) the same steps run with the
kernels' plain versions and no streams.  The JAX package pads the query
batch to a power of two to reuse compiled programs, which the port does
not need.  Top-k (topk) runs on the host, as in the JAX package: the
scores already crossed the link.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from jubatus_tpu_torch.ops import lsh as lshops

# the streamed chunk, rows (a whole number of pages, one page at least)
SPILL_CHUNK_ROWS = 65536
# a chunk whose runs of absent pages hold at least this many bytes each
# (all columns, on average) is copied run by run, else gathered first.
# On an H100 host a run cost 22-38 us of copy calls (two columns) and the
# gather moved 1.2-1.9 GB/s, so the paths crossed between 25 and 175 KB
# a run in 786 KB chunks and near 60 KB in 16.8 MB ones
# (scripts/torch_spill_split.py's copy-path turns, PERF.md §6)
RUN_BYTES_MIN = 64 << 10


def _runs(pages: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Consecutive runs of the ascending pages -> (first pages, lengths)."""
    cut = np.nonzero(np.diff(pages) != 1)[0] + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [pages.size]])
    return pages[starts], ends - starts


def _page_rows_index(pages: np.ndarray, pr: int) -> np.ndarray:
    return (pages[:, None] * pr + np.arange(pr)[None, :]).reshape(-1)


def _page_rows_dev(pages: torch.Tensor, pr: int) -> torch.Tensor:
    """_page_rows_index of pages already on the device."""
    return (pages[:, None] * pr
            + torch.arange(pr, device=pages.device)[None, :]).reshape(-1)


class _Timer:
    """The split of one sweep in device ms (CUDA events; host clock on the
    CPU): pool sweep, chunk copies, chunk sweeps, scores' copy back."""

    KEYS = ("pool_ms", "copy_ms", "chunk_ms", "back_ms")

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks: Dict[str, list] = {k: [] for k in self.KEYS}

    def start(self, stream=None):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def stop(self, key: str, t0, stream=None) -> None:
        if not self.cuda:
            self.marks[key].append((time.perf_counter() - t0) * 1e3)
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        self.marks[key].append((t0, ev))

    def result(self) -> Dict[str, float]:
        out = {}
        for k, v in self.marks.items():
            out[k] = float(sum(m if not self.cuda else m[0].elapsed_time(m[1])
                               for m in v))
        return out


def _sweep(store, names: Sequence[str], nq: int, fill: float,
           sweep: Callable[[Dict[str, torch.Tensor], int], torch.Tensor],
           timing: Optional[dict] = None,
           mask_fill: Optional[float] = None) -> np.ndarray:
    """[nq, capacity] float32 host array of `sweep` over every logical
    slot of a spilled store: the pool in one launch, the absent occupied
    pages streamed; other slots hold `fill`, and with mask_fill the slots
    the occupancy leaves out hold it (set on the card from the pool mask
    and the absent rows' occupancy, copied with the read: the card keeps
    no capacity-wide mask between reads).  sweep(cols, rows) returns
    [nq, rows] float32 on the store's device."""
    dev = store.device_of
    cuda = dev.type == "cuda"
    pr = store.page_rows
    tm = _Timer(dev) if timing is not None else None
    out = torch.full((nq, store.capacity), fill, dtype=torch.float32,
                     device=dev)

    def pool_launch(pool, pool_mask):
        t0 = tm.start() if tm else None
        res = sweep(pool, pool_mask.shape[0])
        if mask_fill is not None:
            res.masked_fill_(~pool_mask[None, :], mask_fill)
        if tm:
            tm.stop("pool_ms", t0)
        return res

    pool_sc, phys_page, absent = store.sweep_pool(names, pool_launch)
    res_phys = np.nonzero(phys_page >= 0)[0]
    # the read's page lists reach the card in one copy: the pool's pages
    # and their logical pages, then the absent pages
    pages = torch.from_numpy(np.concatenate(
        [res_phys, phys_page[res_phys], absent]).astype(np.int64)).to(dev)
    nr = res_phys.size
    if nr:
        out.index_copy_(1, _page_rows_dev(pages[nr: 2 * nr], pr),
                        pool_sc.index_select(1, _page_rows_dev(pages[:nr],
                                                               pr)))
    if absent.size:
        _stream_chunks(store, names, absent, pages[2 * nr:], out, sweep, tm,
                       mask_fill)
    t0 = tm.start() if tm else None
    host_t = torch.empty(out.shape, dtype=torch.float32, pin_memory=cuda)
    host_t.copy_(out, non_blocking=cuda)
    if cuda:
        torch.cuda.current_stream(dev).synchronize()
    host = host_t.numpy()
    if tm:
        tm.stop("back_ms", t0)
        if cuda:
            torch.cuda.current_stream(dev).synchronize()
        timing.update(tm.result())
        timing["streamed_pages"] = int(absent.size)
        timing["streamed_bytes"] = int(absent.size) * pr * sum(
            int(np.prod(store.column_schema(n)[0] or (1,)))
            * store.column_schema(n)[1].itemsize for n in names)
    return host


def _stream_chunks(store, names, absent: np.ndarray,
                   absent_dev: torch.Tensor, out: torch.Tensor, sweep, tm,
                   mask_fill: Optional[float]) -> None:
    """Sweep the absent pages (absent_dev: the same on the card) chunk by
    chunk into out; with mask_fill, the rows the occupancy leaves out hold
    it (their occupancy copied to the card once, beside the chunks)."""
    dev = store.device_of
    pr = store.page_rows
    cp = max(1, SPILL_CHUNK_ROWS // pr)
    chunks = [absent[c0: c0 + cp] for c0 in range(0, absent.size, cp)]
    masters = {n: store.host_column(n) for n in names}
    ok = None
    if mask_fill is not None:
        ok = torch.from_numpy(store.mask_host().reshape(-1, pr)[absent]
                              .reshape(-1)).to(dev)

    def place(sc, i, n_rows):
        """Chunk i's scores [nq, n_rows] into out at its rows."""
        if ok is not None:
            sc.masked_fill_(~ok[None, i * cp * pr: i * cp * pr + n_rows],
                            mask_fill)
        out.index_copy_(1, _page_rows_dev(
            absent_dev[i * cp: i * cp + n_rows // pr], pr), sc)

    if dev.type != "cuda":
        for i, pages in enumerate(chunks):
            rows = torch.from_numpy(_page_rows_index(pages, pr))
            cols = {n: masters[n].index_select(0, rows) for n in names}
            t0 = tm.start() if tm else None
            place(sweep(cols, rows.numel()), i, rows.numel())
            if tm:
                tm.stop("chunk_ms", t0)
        return
    compute = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    # the buffers come from the compute stream's pool: the side stream
    # writes them only after the work queued there so far
    side.wait_stream(compute)
    rows_max = cp * pr
    bufs = [{n: torch.empty((rows_max,) + tuple(masters[n].shape[1:]),
                            dtype=masters[n].dtype, device=dev)
             for n in names} for _ in range(2)]
    row_bytes = sum(int(np.prod(masters[n].shape[1:]))
                    * masters[n].element_size() for n in names)
    staging = [None, None]
    copied = [torch.cuda.Event(), torch.cuda.Event()]
    consumed = [None, None]
    for i, pages in enumerate(chunks):
        k = i % 2
        n_rows = pages.size * pr
        firsts, lens = _runs(pages)
        with torch.cuda.stream(side):
            if consumed[k] is not None:
                side.wait_event(consumed[k])    # chunk i - 2's sweep done
            t0 = tm.start(side) if tm else None
            if n_rows * row_bytes >= RUN_BYTES_MIN * firsts.size:
                off = 0
                for p0, ln in zip(firsts.tolist(), lens.tolist()):
                    for n in names:
                        bufs[k][n][off: off + ln * pr].copy_(
                            masters[n][p0 * pr: (p0 + ln) * pr],
                            non_blocking=True)
                    off += ln * pr
            else:
                if staging[k] is None:
                    staging[k] = {n: torch.empty(
                        bufs[k][n].shape, dtype=masters[n].dtype,
                        pin_memory=True) for n in names}
                else:
                    copied[k].synchronize()     # its last copy is done
                rows = _page_rows_index(pages, pr)
                for n in names:
                    np.take(masters[n].numpy(), rows, axis=0,
                            out=staging[k][n][:n_rows].numpy())
                    bufs[k][n][:n_rows].copy_(staging[k][n][:n_rows],
                                              non_blocking=True)
            if tm:
                tm.stop("copy_ms", t0, side)
            copied[k].record(side)
        compute.wait_event(copied[k])
        t0 = tm.start() if tm else None
        place(sweep({n: bufs[k][n][:n_rows] for n in names}, n_rows), i,
              n_rows)
        if tm:
            tm.stop("chunk_ms", t0)
        ev = torch.cuda.Event()
        ev.record(compute)
        consumed[k] = ev


def sig_scores(store, kind: str, hash_num: int, q_sigs, qnorms,
               sig_col: str = "sig", norm_col: str = "norms",
               timing: Optional[dict] = None) -> np.ndarray:
    """[Nq, capacity] float32 similarities over every logical slot of a
    spilled store (K5's scores mode on the pool and on each streamed
    chunk); the slots the occupancy leaves out score -inf."""
    dev = store.device_of
    q = np.ascontiguousarray(np.asarray(q_sigs, np.uint32).reshape(
        len(q_sigs), -1)).view(np.int32)
    qs = torch.from_numpy(q.copy()).to(dev)
    qn = torch.from_numpy(np.asarray(qnorms, np.float32).copy()).to(dev)

    def sweep(cols, rows):
        return lshops.sig_scores(kind, cols[sig_col], qs, cols[norm_col], qn,
                                 hash_num)

    return _sweep(store, (sig_col, norm_col), q.shape[0], -np.inf, sweep,
                  timing, mask_fill=-np.inf)


def dense_dots(store, q_dense, idx_col: str = "indices",
               val_col: str = "values",
               timing: Optional[dict] = None) -> np.ndarray:
    """[Nq, capacity] float32 sparse-row dots over every logical slot of
    a spilled store (K4 dense_dots on the pool and on each streamed
    chunk); the slots of empty absent pages hold 0."""
    dev = store.device_of
    qd = torch.from_numpy(np.ascontiguousarray(q_dense, np.float32)).to(dev)

    def sweep(cols, rows):
        return lshops.dense_dots(cols[idx_col], cols[val_col], qd)

    return _sweep(store, (idx_col, val_col), qd.shape[0], 0.0, sweep,
                  timing)


def dense_scores(store, metric: str, q_dense, qnorm: float,
                 norm_col: str = "norms",
                 timing: Optional[dict] = None) -> np.ndarray:
    """[capacity] float32 exact-method scores (higher is closer) of one
    dense query over a spilled store: the dots streamed, then the JAX
    package's numpy float32 arithmetic on the host (cosine dots /
    max(n qn, 1e-12); euclid -sqrt(max(qn qn + n n - 2 dots, 0)))."""
    dots = dense_dots(store, np.asarray(q_dense, np.float32)[None],
                      timing=timing)[0]
    norms = store.read(norm_col, np.arange(store.capacity))
    if metric == "cosine":
        sc = dots / np.maximum(norms * np.float32(qnorm),
                               np.float32(1e-12))
    else:
        d2 = np.float32(qnorm) * np.float32(qnorm) + norms * norms \
            - np.float32(2.0) * dots
        sc = -np.sqrt(np.maximum(d2, np.float32(0.0)))
    sc = sc.astype(np.float32)
    sc[~store.mask_host()[: store.capacity]] = -np.inf
    return sc


def topk(scores: np.ndarray, mask: np.ndarray, k: int
         ) -> Tuple[np.ndarray, np.ndarray]:
    """Descending top-k over a [capacity] score vector on the host (the
    port's topk_rows, the JAX package's)."""
    return lshops.topk_rows(scores, mask[: scores.shape[0]], int(k),
                            largest=True)
