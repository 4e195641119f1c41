"""Service tables and their binding to the RPC server (counterpart of
jubatus_tpu/framework/service.py: the classifier, regression,
nearest_neighbor, recommender and anomaly tables and the common RPCs).

Each service is a table of Method specs bound to driver callables.  Every
method takes the cluster `name` as wire argument 0, and datum/result
shapes follow the reference IDL.  Argument 0 is the model-slot key
(tenancy/registry.py): a registered slot's name routes the call to that
slot (its driver, model lock, journal, query cache, read lane, raw-train
dispatcher and quota), any other name to the default slot; a raw train
frame in a process with several slots is routed by peeking its name.
Each call but a server-to-server one is first admitted against its
slot's tenant quota (TRAIN for updates, QUERY for reads).

Locking follows the reference's JRLOCK_/JWLOCK_: read handlers hold the
model read lock (or ride the read lane, one hold per fused sweep, with
--read_batch_window_us), update handlers first flush() the raw-train
dispatcher (so every acked train lands before them) and then hold the
write lock.  With a journal (--journal) an update is refused while the
journal is stalled, appended under the write lock after it applied, and
committed after the lock, before the ack.  Decoded handlers run on the
RPC event loop.  Wire `train` frames take the raw route (raw_train):
with an eligible converter config they go to the IngestPipeline
(framework/dispatch.py) without being decoded in Python, or with
--ingest_depth 0 are converted on their RPC worker and coalesced by the
TrainDispatcher; under inline dispatch (--dispatch inline) a read burst's
frames are one fused step on the event loop (raw_train_batch).  A config
the native converter does not cover is decoded and trained like any
update.  Reads go through the epoch-keyed query cache first when it is
on (--query_cache_entries / --query_cache_bytes): a hit answers the
pre-encoded body.  With the tracer on, handlers tag the request's root
span with their stages (flush, lock wait, dispatch or device, journal,
convert).  do_mix runs on the RPC
server's call pool (threaded): it flushes the ingest pipeline, then the
mixer fans get_diff and put_diff out to every member, this server
included.  Anomaly's add is the one handler that takes its own locks
(Method.nolock): it mints the row's id, then writes the row under the
write lock, journaled as a `drv` record that carries the id, standalone;
in a cluster it writes the CHT's two owners of the id, the primary
required and the replica best effort (with --routing partition its one
owner).

Each Method also carries the JAX table's routing spec, which the proxy
(framework/proxy.py) reads: its routing (random, broadcast, cht or
internal), the aggregator that folds a broadcast or cht answer, the cht
replica count, and the partition-mode ScatterRead
(framework/partition.py).  The partition plane's internal methods
(partition_query_*, the *_partial legs, partition_accept_rows and
partition_drop_rows) are server-to-server and proxy-internal: the proxy
does not register them.  get_metrics and get_traces answer the metrics
map and the span ring (framework/server_base.py); create_model,
drop_model and list_models manage the slot registry (activate_model, the
autopilot's slot migration, is refused: ROADMAP Queue 1 item 7, with the
heat and SLO accounting).
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import msgpack

from jubatus_tpu_torch.durability.journal import check_writable
from jubatus_tpu_torch.framework.dispatch import TrainDispatcher
from jubatus_tpu_torch.framework.partition import ScatterRead
from jubatus_tpu_torch.framework.query_cache import pack_wire
from jubatus_tpu_torch.fv import Datum
from jubatus_tpu_torch.mix.linear_mixer import LinearMixer
from jubatus_tpu_torch.obs.trace import TRACER as _tracer
from jubatus_tpu_torch.rpc.server import PreEncoded
from jubatus_tpu_torch.tenancy.quotas import QUERY, TRAIN
from jubatus_tpu_torch.tenancy.registry import (SlotMixRouter,
                                                later_slot_refusal,
                                                peek_frame_model)
from jubatus_tpu_torch.utils.metrics import GLOBAL as _metrics

log = logging.getLogger("jubatus_tpu_torch.service")

# routing modes (the proxy's register_async_random / broadcast / cht)
RANDOM = "random"
BROADCAST = "broadcast"
CHT = "cht"
INTERNAL = "internal"     # server-to-server only, never proxied

# aggregators of the proxy's broadcast and cht joins
AGG_PASS = "pass"
AGG_ALL_AND = "all_and"
AGG_ALL_OR = "all_or"
AGG_CONCAT = "concat"
AGG_MERGE = "merge"
AGG_ADD = "add"


@dataclass
class Method:
    name: str
    fn: Callable[..., Any]        # fn(server, *wire_args) -> wire result
    update: bool = False          # write-locks + counts as a model update
    # the handler takes its own locks and writes its own journal record
    # (anomaly's add: a server-generated id, replica writes to peers); it
    # runs on the RPC call pool, since it may call other servers
    nolock: bool = False
    routing: str = RANDOM
    aggregator: str = AGG_PASS
    cht_replicas: int = 2
    # the read lane's entry: many(server, [wire_args, ...]) ->
    # [wire_result, ...] runs N concurrent calls as ONE fused sweep
    # (framework/dispatch.ReadDispatcher); None: the lane loops fn
    many: Optional[Callable[..., Any]] = None
    # the partition-mode scatter spec: behind a `--routing partition`
    # proxy a read that carries one scatters to every partition and the
    # proxy merges the partial top-ks; None keeps the declared routing
    partition: Optional[ScatterRead] = None


class ServiceDef:
    def __init__(self, name: str, methods: List[Method]):
        self.name = name
        self.methods: Dict[str, Method] = {m.name: m for m in methods}


SERVICES: Dict[str, ServiceDef] = {}


def register_service(sd: ServiceDef) -> ServiceDef:
    SERVICES[sd.name] = sd
    return sd


def _to_str(x) -> str:
    """Normalize wire/msgpack values that may arrive as bytes."""
    return x.decode() if isinstance(x, bytes) else x


def _datum(obj) -> Datum:
    return Datum.from_msgpack(obj)


def _build_train_dispatcher(slot):
    """One slot's threaded raw-train dispatcher: the IngestPipeline at
    --ingest_depth > 0, else the per-request TrainDispatcher, both with
    --batch_max and --batch_window_us."""
    from jubatus_tpu_torch.framework.dispatch import IngestPipeline
    args = slot.args
    max_wait = args.batch_window_us / 1e6
    if args.ingest_depth > 0:
        return IngestPipeline(slot, max_batch=args.batch_max,
                              max_wait_s=max_wait, depth=args.ingest_depth)
    return TrainDispatcher(slot, max_batch=args.batch_max,
                           max_wait_s=max_wait)


def setup_slot_pipelines(slot) -> None:
    """One model slot's read lane and raw-train dispatcher (the server
    itself is its default slot), threaded dispatch only: inline dispatch runs all device work on the event loop, with
    nothing to coalesce on other threads.  The lane exists when
    --read_batch_window_us > 0.  The dispatcher exists when the native
    converter covers the slot's config; otherwise its train frames take
    the decoded route.  The default slot gets them at bind_service, an
    admitted slot at create_model (tenancy/registry.py)."""
    from jubatus_tpu_torch.framework.dispatch import ReadDispatcher
    inline = slot.dispatch_mode == "inline"
    window_us = slot.args.read_batch_window_us
    if window_us > 0 and not inline and slot.read_dispatch is None:
        slot.read_dispatch = ReadDispatcher(slot, window_us)
    sd = SERVICES.get(slot.args.type)
    if (sd is not None and "train" in sd.methods and not inline
            and slot.dispatcher is None
            and getattr(slot.driver, "_fast", None) is not None):
        slot.dispatcher = _build_train_dispatcher(slot)


def _cache_fill(cache, key, result):
    """The fill half of query_cache.serve_cached, for an answer the read
    handler computed after its own probe missed: pack it once, store it
    and answer the packed body (an answer that does not pack bypasses)."""
    try:
        body = pack_wire(result)
    except Exception:  # noqa: BLE001 - served direct, counted
        cache.bypass()
        return result
    cache.put(key, body)
    return PreEncoded(body)


def _cache_fill_when_done(cache, key, fut: Future) -> Future:
    """_cache_fill for a read queued on the lane, once it answered."""
    out: Future = Future()

    def done(f: Future) -> None:
        try:
            out.set_result(_cache_fill(cache, key, f.result()))
        except BaseException as e:  # noqa: BLE001 - to this caller
            out.set_exception(e)

    fut.add_done_callback(done)
    return out


def bind_service(server, rpc_server) -> None:
    """Attach the server's service methods, its raw train route, the
    common RPCs and the tenancy RPCs.  Argument 0 of every call resolves
    to a model slot (server.slot_for): the slot's own lock, journal,
    query cache, read lane, dispatcher and quota serve it."""
    sd = SERVICES[server.args.type]
    # a threaded handler's local device mutation runs where the process's
    # device work runs (the event loop in inline mode; _locked_update)
    server.device_call = rpc_server.device_call
    inline = bool(rpc_server.inline_raw)
    server.dispatch_mode = "inline" if inline else "threaded"
    # the default slot's pipelines now, and those of slots restored from
    # the catalog before the bind; a slot admitted later gets its own at
    # create_model (tenancy/registry.py calls the factory)
    server._pipeline_factory = setup_slot_pipelines
    for slot in server.slots.all():
        setup_slot_pipelines(slot)
    slots = server.slots
    default = slots.default
    _slot = slots.resolve

    def _flush(s):
        # order acked raw trains before any other model change; never
        # under the model lock (framework/dispatch.py)
        if s.dispatcher is not None:
            s.dispatcher.flush()

    def wrap(m: Method):
        # server-to-server methods (the partition plane's legs and
        # handoff) never burn a tenant's quota
        quota_kind = None if m.routing == INTERNAL \
            else (TRAIN if (m.update or m.nolock) else QUERY)
        if m.nolock:
            def handler(_name, *args, _m=m, _qk=quota_kind):
                s = _slot(_name)
                if _qk is not None:
                    s.admit(_qk)
                if _tracer.enabled:
                    _tracer.tag_current("model", s.slot_name)
                return _m.fn(s, *args)
        elif m.update:
            def handler(_name, *args, _m=m, _qk=quota_kind):
                s = _slot(_name)
                if _qk is not None:
                    s.admit(_qk)
                # fail-stop gate: a stalled journal refuses the write
                # before the model mutates; reads go on being served
                check_writable(s.journal)
                # stage tags on the request's root span (rpc/server.py);
                # `tr is None`, the default, skips every clock read
                tr = _tracer if _tracer.enabled else None
                if tr is None:
                    _flush(s)
                    return _locked_update(
                        s, lambda: _m.fn(s, *args),
                        {"k": "u", "m": _m.name, "a": list(args)})
                tr.tag_current("model", s.slot_name)
                t0 = time.monotonic()
                _flush(s)
                tr.tag_current("stage.flush_s",
                               round(time.monotonic() - t0, 6))
                return _locked_update(
                    s, lambda: _m.fn(s, *args),
                    {"k": "u", "m": _m.name, "a": list(args)}, tracer=tr)
        else:
            # the read path: (1) the slot's epoch-keyed cache, whose hit
            # is the pre-encoded body, with no lock, sweep or encode; the
            # epoch is read BEFORE the compute, so an answer computed
            # beside an update is stored under the pre-update epoch and
            # never served to a reader that saw the update's ack; (2) the
            # slot's read lane's fused sweep; (3) the slot's read lock
            def handler(_name, *args, _m=m, _qk=quota_kind):
                s = _slot(_name)
                if _qk is not None:
                    s.admit(_qk)
                cache = s.query_cache
                key = cache.key(_m.name, args, s.model_epoch) \
                    if cache is not None else None
                if key is not None:
                    body = cache.get(key)
                    if body is not None:
                        return PreEncoded(body)
                tr = _tracer if _tracer.enabled else None
                if tr is not None:
                    tr.tag_current("model", s.slot_name)
                    if cache is not None:
                        tr.tag_current("cache", "miss")
                rd = s.read_dispatch
                if rd is not None:
                    # a Future: the RPC loop awaits the fused sweep, whose
                    # own span (read.sweep.<method>) splits lock and device
                    fut = rd.submit(_m, args)
                    return fut if key is None \
                        else _cache_fill_when_done(cache, key, fut)

                def compute():
                    if tr is None:
                        with s.model_lock.read():
                            return _m.fn(s, *args)
                    t0 = time.monotonic()
                    with s.model_lock.read():
                        t1 = time.monotonic()
                        tr.tag_current("stage.lock_wait_s",
                                       round(t1 - t0, 6))
                        out = _m.fn(s, *args)
                    # read answers are host values: device + readback
                    tr.tag_current("stage.device_s",
                                   round(time.monotonic() - t1, 6))
                    return out

                return _cache_fill(cache, key, compute()) \
                    if key is not None else compute()
        return handler

    for m in sd.methods.values():
        rpc_server.add(m.name, wrap(m), threaded=m.nolock)

    if "train" in sd.methods and hasattr(default.driver, "train_raw"):
        _plain_train = wrap(sd.methods["train"])

        def _raw_slot(msg, params_off):
            # one attribute check with one slot; a multi-slot process
            # peeks the frame's model name (argument 0)
            if not slots.multi:
                return default
            return slots.resolve(peek_frame_model(msg, params_off))

        def raw_train(msg: bytes, params_off: int):
            """Runs on an RPC worker thread.  Returns the result, or a
            Future the RPC layer awaits before the ack."""
            s = _raw_slot(msg, params_off)
            drv = s.driver
            if getattr(drv, "_fast", None) is None:
                # the config needs the Python converter: decode and train
                # like any update (the reference's routing)
                params = msgpack.unpackb(msg, raw=False,
                                         strict_map_key=False,
                                         unicode_errors="surrogateescape")[3]
                return _plain_train(*params)
            s.admit(TRAIN)
            check_writable(s.journal)
            tr = _tracer if _tracer.enabled else None
            if tr is not None:
                tr.tag_current("model", s.slot_name)
            dispatcher = s.dispatcher
            if dispatcher.accepts_raw_frames:
                # the frame goes straight to the pipeline's convert stage;
                # frames arrive in wire order and its queues are FIFO
                return dispatcher.submit(msg, params_off)
            # the per-request route: stage 1 here, without the model
            # lock, overlapping earlier requests' steps; submitted under
            # convert_lock, so conversion order is queue order
            t0 = time.monotonic()
            with drv.convert_lock:
                _metrics.observe("convert_lock_wait", time.monotonic() - t0)
                conv = drv.convert_raw_request(msg, params_off)
                if tr is not None:
                    tr.tag_current("stage.convert_s",
                                   round(time.monotonic() - t0, 6))
                return dispatcher.submit((conv, msg, params_off))

        def _slot_train_batch(s, frames):
            """Inline dispatch: one slot's frames of a read burst as one
            convert pass and ONE fused device step, on the event loop."""
            drv = s.driver
            if getattr(drv, "_fast", None) is None:
                return [raw_train(m, o) for m, o in frames]
            s.admit(TRAIN, n=len(frames))
            journal = s.journal
            check_writable(journal)
            t0 = time.monotonic()
            with drv.convert_lock:
                _metrics.observe("convert_lock_wait", time.monotonic() - t0)
                rb = drv.convert_raw_batch(frames)
            spent = s.__dict__.setdefault("_inline_arenas", [])
            try:
                with s.model_lock.write():
                    ns = drv.train_converted_batch(rb)
                    for _ in frames:
                        s.event_model_updated()
                    if journal is not None:
                        # one record a fused batch, as the dispatchers do
                        journal.append(
                            {"k": "train",
                             "f": [[bytes(m), int(o)] for m, o in frames]},
                            s.current_mix_round())
                if journal is not None:
                    journal.commit()
            finally:
                if rb.arena is not None:
                    spent.append(rb.arena)
                    rb.arena = None
            # the periodic sync bounds the device backlog and is the fence
            # after which the consumed arenas go back to the pool
            s._inline_ops = getattr(s, "_inline_ops", 0) + 1
            if s._inline_ops % TrainDispatcher.SYNC_EVERY == 0:
                with _metrics.time("device_step"):
                    drv.device_sync()
                s._inline_arenas = []
                for arena in spent:
                    drv.arena_pool.release(arena)
            return ns

        def raw_train_batch(frames):
            if not slots.multi:
                return _slot_train_batch(default, frames)
            # a burst may interleave slots: each slot's frames are one
            # fused batch, the answers reassembled in frame order.  A
            # failure (a quota rejection, a bad frame) faults only its
            # slot's frames: the other groups were applied and journaled,
            # and error-acking them would make their callers re-send
            from jubatus_tpu_torch.rpc.server import InlineFault
            out = [None] * len(frames)
            groups = {}
            for i, (m, o) in enumerate(frames):
                s = _raw_slot(m, o)
                groups.setdefault(id(s), (s, []))[1].append(i)
            for s, idxs in groups.values():
                try:
                    rs = _slot_train_batch(s, [frames[i] for i in idxs])
                except Exception as e:  # noqa: BLE001 - relayed per frame
                    log.warning("inline train batch failed for model %s: "
                                "%s", s.slot_name, e)
                    rs = [InlineFault(str(e))] * len(idxs)
                for i, r in zip(idxs, rs):
                    out[i] = r
            return out

        if inline:
            # the same fused-step bound as the threaded routes
            rpc_server.inline_batch_max = server.args.batch_max
        rpc_server.add_raw("train", raw_train, batch_fn=raw_train_batch)

    # the common RPCs, per slot: save, load, clear and get_config act on
    # the model the wire name addresses (files keyed by the slot's name)
    def _save(_n, mid):
        s = _slot(_n)
        _flush(s)
        return s.save(_to_str(mid))

    def _load(_n, mid):
        s = _slot(_n)
        _flush(s)
        return s.load(_to_str(mid))

    def _clear(_n):
        s = _slot(_n)
        _flush(s)
        return s.clear()

    def _do_mix(_n):
        # every acked train lands before the round's snapshot
        _flush(_slot(_n))
        return server.do_mix(_n)

    rpc_server.add("get_config", lambda _n: _slot(_n).get_config())
    rpc_server.add("save", _save)
    rpc_server.add("load", _load)
    rpc_server.add("get_status", lambda _n: server.get_status())
    rpc_server.add("clear", _clear)
    # do_mix's fan-out includes a self-call: on the loop it would wait on
    # itself, so it runs on the call pool
    rpc_server.add("do_mix", _do_mix, threaded=True)
    # the exporter's /metrics.json and /traces.json over RPC, shaped as
    # get_status, so a proxy broadcast-merges them alike
    rpc_server.add("get_metrics", lambda _n=None: server.get_metrics())
    rpc_server.add("get_traces", lambda _n=None: server.get_traces())
    # the admission plane: registry mutations run off the event loop
    # (driver construction, catalog IO and coordinator calls must not
    # stall it) and never under a model lock (the registry's guard);
    # list_models is host-dict work
    rpc_server.add("create_model",
                   lambda _n, spec: server.create_model(spec), threaded=True)
    rpc_server.add("drop_model",
                   lambda _n, mname: server.drop_model(_to_str(mname)),
                   threaded=True)
    rpc_server.add("list_models", lambda _n=None: server.list_models())
    rpc_server.add("activate_model", _refuse_activate)
    mixer = server.mixer
    # a CollectiveMixer's wire is its inner LinearMixer (none standalone)
    wire = getattr(mixer, "inner", mixer)
    if isinstance(wire, LinearMixer):
        # the name-routed MIX wire: one get_diff / put_diff / get_model
        # registration that dispatches on the frame's model field to the
        # slots' mixers (through a CollectiveMixer's delegates); a frame
        # without one is the default slot's, byte for byte the
        # single-model wire
        SlotMixRouter(server).register_api(rpc_server)
    elif mixer is not None:
        # the gossip mixers keep their own wire (pull / push), the default
        # slot's only: admitted slots run unmixed under them
        mixer.register_api(rpc_server)


def _refuse_activate(*_args):
    raise NotImplementedError(later_slot_refusal("activate_model"))


# ---------------------------------------------------------------------------
# the read lane's batched entries (Method.many): N concurrent wire calls as
# the driver's one *_many sweep, encoded per call as Method.fn encodes one
# ---------------------------------------------------------------------------

def _classify_many(s, calls):
    groups = [[_datum(d) for d in data] for (data,) in calls]
    return [[[[lbl, sc] for lbl, sc in row] for row in rows]
            for rows in s.driver.classify_many(groups)]


def _estimate_many(s, calls):
    return s.driver.estimate_many([[_datum(d) for d in data]
                                   for (data,) in calls])


# ---------------------------------------------------------------------------
# classifier (server/classifier.idl)
# ---------------------------------------------------------------------------

register_service(ServiceDef("classifier", [
    Method("train",
           lambda s, data: s.driver.train(
               [(_to_str(lbl), _datum(d)) for lbl, d in data]),
           update=True, routing=RANDOM, aggregator=AGG_PASS),
    Method("classify",
           lambda s, data: [
               [[lbl, sc] for lbl, sc in row]
               for row in s.driver.classify([_datum(d) for d in data])],
           routing=RANDOM, aggregator=AGG_PASS, many=_classify_many),
    Method("get_labels", lambda s: s.driver.get_labels(),
           routing=RANDOM, aggregator=AGG_PASS),
    Method("set_label", lambda s, lbl: s.driver.set_label(_to_str(lbl)),
           update=True, routing=BROADCAST, aggregator=AGG_ALL_AND),
    Method("delete_label", lambda s, lbl: s.driver.delete_label(_to_str(lbl)),
           update=True, routing=BROADCAST, aggregator=AGG_ALL_OR),
]))


# ---------------------------------------------------------------------------
# regression (server/regression.idl)
# ---------------------------------------------------------------------------

register_service(ServiceDef("regression", [
    Method("train",
           lambda s, data: s.driver.train(
               [(float(score), _datum(d)) for score, d in data]),
           update=True, routing=RANDOM, aggregator=AGG_PASS),
    Method("estimate",
           lambda s, data: s.driver.estimate([_datum(d) for d in data]),
           routing=RANDOM, aggregator=AGG_PASS, many=_estimate_many),
]))


# ---------------------------------------------------------------------------
# nearest_neighbor (server/nearest_neighbor.idl)
# ---------------------------------------------------------------------------

def _id_scores(rows):
    return [[i, s] for i, s in rows]


def _nn_query_many(s, calls, kind: str):
    pairs = [(_datum(d), int(size)) for d, size in calls]
    return [_id_scores(out)
            for out in getattr(s.driver, f"{kind}_many")(pairs)]


def _partition_methods(*reads: Method) -> List[Method]:
    """A row engine's partition plane: its internal read legs, then the
    handoff's journaled accept and drop."""
    return list(reads) + [
        Method("partition_accept_rows",
               lambda s, p: s.driver.partition_apply_rows(p),
               update=True, routing=INTERNAL, aggregator=AGG_PASS),
        Method("partition_drop_rows",
               lambda s, ids: s.driver.partition_drop_rows(list(ids or [])),
               update=True, routing=INTERNAL, aggregator=AGG_PASS),
    ]


register_service(ServiceDef("nearest_neighbor", [
    Method("set_row",
           lambda s, i, d: s.driver.set_row(_to_str(i), _datum(d)),
           update=True, routing=CHT, cht_replicas=1, aggregator=AGG_PASS),
    Method("neighbor_row_from_id",
           lambda s, i, size: _id_scores(
               s.driver.neighbor_row_from_id(_to_str(i), int(size))),
           routing=RANDOM, aggregator=AGG_PASS,
           partition=ScatterRead(ascending=True,
                                 fetch="partition_query_sig",
                                 scatter="neighbor_row_from_sig_partial")),
    Method("neighbor_row_from_datum",
           lambda s, d, size: _id_scores(
               s.driver.neighbor_row_from_datum(_datum(d), int(size))),
           routing=RANDOM, aggregator=AGG_PASS,
           many=lambda s, calls: _nn_query_many(
               s, calls, "neighbor_row_from_datum"),
           partition=ScatterRead(ascending=True)),
    Method("similar_row_from_id",
           lambda s, i, n: _id_scores(
               s.driver.similar_row_from_id(_to_str(i), int(n))),
           routing=RANDOM, aggregator=AGG_PASS,
           partition=ScatterRead(fetch="partition_query_sig",
                                 scatter="similar_row_from_sig_partial")),
    Method("similar_row_from_datum",
           lambda s, d, n: _id_scores(
               s.driver.similar_row_from_datum(_datum(d), int(n))),
           routing=RANDOM, aggregator=AGG_PASS,
           many=lambda s, calls: _nn_query_many(
               s, calls, "similar_row_from_datum"),
           partition=ScatterRead()),
    Method("get_all_rows", lambda s: s.driver.get_all_rows(),
           routing=BROADCAST, aggregator=AGG_CONCAT),
] + _partition_methods(
    Method("partition_query_sig",
           lambda s, i: s.driver.partition_query_sig(_to_str(i)),
           routing=INTERNAL, aggregator=AGG_PASS),
    # the legs take the fetched [sig, norm] payload as one wire argument,
    # in the id's place of the public signature
    Method("neighbor_row_from_sig_partial",
           lambda s, payload, size: _id_scores(
               s.driver.neighbor_row_from_sig_partial(
                   payload[0], float(payload[1]), int(size))),
           routing=INTERNAL, aggregator=AGG_PASS),
    Method("similar_row_from_sig_partial",
           lambda s, payload, size: _id_scores(
               s.driver.similar_row_from_sig_partial(
                   payload[0], float(payload[1]), int(size))),
           routing=INTERNAL, aggregator=AGG_PASS))))


# ---------------------------------------------------------------------------
# recommender (server/recommender.idl)
# ---------------------------------------------------------------------------

def _reco_similar_many(s, calls):
    pairs = [(_datum(d), int(size)) for d, size in calls]
    return [_id_scores(out)
            for out in s.driver.similar_row_from_datum_many(pairs)]


def _calc_score_many(s, calls):
    return s.driver.calc_score_many([_datum(d) for (d,) in calls])


register_service(ServiceDef("recommender", [
    Method("clear_row", lambda s, i: s.driver.clear_row(_to_str(i)),
           update=True, routing=CHT, aggregator=AGG_ALL_AND),
    Method("update_row",
           lambda s, i, d: s.driver.update_row(_to_str(i), _datum(d)),
           update=True, routing=CHT, aggregator=AGG_ALL_AND),
    Method("complete_row_from_id",
           lambda s, i: s.driver.complete_row_from_id(
               _to_str(i)).to_msgpack(),
           routing=CHT, aggregator=AGG_PASS),
    Method("complete_row_from_datum",
           lambda s, d: s.driver.complete_row_from_datum(
               _datum(d)).to_msgpack(),
           routing=RANDOM, aggregator=AGG_PASS),
    Method("similar_row_from_id",
           lambda s, i, size: _id_scores(
               s.driver.similar_row_from_id(_to_str(i), int(size))),
           routing=CHT, aggregator=AGG_PASS,
           partition=ScatterRead(fetch="partition_query_fv",
                                 scatter="similar_row_from_fv_partial")),
    Method("similar_row_from_datum",
           lambda s, d, size: _id_scores(
               s.driver.similar_row_from_datum(_datum(d), int(size))),
           routing=RANDOM, aggregator=AGG_PASS, many=_reco_similar_many,
           partition=ScatterRead()),
    Method("decode_row",
           lambda s, i: s.driver.decode_row(_to_str(i)).to_msgpack(),
           routing=CHT, aggregator=AGG_PASS),
    Method("get_all_rows", lambda s: s.driver.get_all_rows(),
           routing=BROADCAST, aggregator=AGG_CONCAT),
    Method("calc_similarity",
           lambda s, lhs, rhs: s.driver.calc_similarity(_datum(lhs),
                                                        _datum(rhs)),
           routing=RANDOM, aggregator=AGG_PASS),
    Method("calc_l2norm", lambda s, d: s.driver.calc_l2norm(_datum(d)),
           routing=RANDOM, aggregator=AGG_PASS),
] + _partition_methods(
    Method("partition_query_fv",
           lambda s, i: s.driver.partition_query_fv(_to_str(i)),
           routing=INTERNAL, aggregator=AGG_PASS),
    Method("similar_row_from_fv_partial",
           lambda s, fv, size: _id_scores(
               s.driver.similar_row_from_fv_partial(fv, int(size))),
           routing=INTERNAL, aggregator=AGG_PASS))))


def _self_loc(s):
    return (s.ip, s.args.rpc_port)


def _peer_call(s, host: str, port: int, method: str, *args):
    """One server-to-server RPC, argument 0 the cluster name."""
    from jubatus_tpu_torch.rpc.client import Client
    with Client(host, port, timeout=s.args.interconnect_timeout) as c:
        return c.call_raw(method, s.args.name, *args)


def _locked_update(s, fn, record, tracer=None):
    """A model mutation under the write lock, journaled as `record` (its
    server-generated id already in it, or replay would mint another) and
    committed before the ack; refused while the journal is stalled.  It
    runs through the server's device_call, so a threaded handler's local
    mutation runs on the event loop under inline dispatch.  With
    `tracer`, the stage tags of the request's root span: lock wait,
    dispatch (the kernels are enqueued, not finished: obs/trace.py) and
    journal commit."""
    journal = s.journal
    check_writable(journal)

    def locked():
        t0 = time.monotonic() if tracer is not None else 0.0
        with s.model_lock.write():
            if tracer is not None:
                t1 = time.monotonic()
                tracer.tag_current("stage.lock_wait_s", round(t1 - t0, 6))
            result = fn()
            s.event_model_updated()
            if tracer is not None:
                tracer.tag_current("stage.dispatch_s",
                                   round(time.monotonic() - t1, 6))
            # after the apply (a failed update must not replay), under
            # the lock (a snapshot's position matches its pack)
            if journal is not None:
                journal.append(record, s.current_mix_round())
        return result

    device_call = getattr(s, "device_call", None)
    result = locked() if device_call is None else device_call(locked)
    if journal is not None:
        # durable before the ack, outside the lock
        t3 = time.monotonic() if tracer is not None else 0.0
        journal.commit()
        if tracer is not None:
            tracer.tag_current("stage.journal_s",
                               round(time.monotonic() - t3, 6))
    return result


def _anomaly_add(s, d):
    """Mint an id, then write the row: standalone under the write lock
    (the `drv` record); in a cluster to the id's two CHT owners, the
    primary required and the replica best effort (the JAX service's
    rule, anomaly_serv.cpp:152-205 of the reference); with --routing
    partition to its one owner, whose hash range holds it."""
    id_ = str(s.idgen())
    record = {"k": "drv", "m": "add", "a": [id_, d]}

    def local():
        return _locked_update(s, lambda: s.driver.add(id_, _datum(d)),
                              record)

    if s.cht is None:
        return [id_, local()]
    replicas = 1 if s.args.routing == "partition" else 2
    owners = s.cht.find(id_, replicas)
    if not owners:
        raise RuntimeError(f"no server found in cht: {s.args.name}")
    score = 0.0
    for i, (host, port) in enumerate(owners):
        try:
            if (host, port) == _self_loc(s):
                r = local()
            else:
                r = _peer_call(s, host, port, "update", id_, d)
            if i == 0:
                score = float(r)
        except Exception as e:  # noqa: BLE001 - the replica is best effort
            if i == 0:
                raise
            log.warning("anomaly replica write of id %s to %s:%d failed: "
                        "%s", id_, host, port, e)
    return [id_, score]


register_service(ServiceDef("anomaly", [
    Method("add", _anomaly_add,
           nolock=True, routing=RANDOM, aggregator=AGG_PASS),
    Method("update",
           lambda s, i, d: s.driver.update(_to_str(i), _datum(d)),
           update=True, routing=CHT, aggregator=AGG_PASS),
    Method("overwrite",
           lambda s, i, d: s.driver.overwrite(_to_str(i), _datum(d)),
           update=True, routing=CHT, aggregator=AGG_PASS),
    Method("clear_row", lambda s, i: s.driver.clear_row(_to_str(i)),
           update=True, routing=CHT, aggregator=AGG_ALL_AND),
    Method("calc_score", lambda s, d: s.driver.calc_score(_datum(d)),
           routing=RANDOM, aggregator=AGG_PASS, many=_calc_score_many,
           partition=ScatterRead(merge="anomaly",
                                 scatter="calc_score_partial")),
    Method("get_all_rows", lambda s: s.driver.get_all_rows(),
           routing=BROADCAST, aggregator=AGG_CONCAT),
] + _partition_methods(
    Method("calc_score_partial",
           lambda s, d: s.driver.calc_score_partial(_datum(d)),
           routing=INTERNAL, aggregator=AGG_PASS))))
