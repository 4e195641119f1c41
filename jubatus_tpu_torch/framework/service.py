"""Service tables and their binding to the RPC server (counterpart of
jubatus_tpu/framework/service.py, classifier table + common RPCs).

Each service is a table of Method specs bound to driver callables.  Every
method takes the cluster `name` as wire argument 0 (dropped server-side),
and datum/result shapes follow the reference IDL.  Update methods bump the
server's update counter; all handlers run on the RPC event-loop thread.
do_mix, the journal, tenancy and the observability planes are later work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List

from jubatus_tpu_torch.fv import Datum


@dataclass
class Method:
    name: str
    fn: Callable[..., Any]        # fn(server, *wire_args) -> wire result
    update: bool = False          # counts as a model update


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


def bind_service(server, rpc_server) -> None:
    """Attach the server's service methods and the common RPCs."""
    sd = SERVICES[server.args.type]

    def wrap(m: Method):
        if m.update:
            def handler(_name, *args, _m=m):
                result = _m.fn(server, *args)
                server.event_model_updated()
                return result
        else:
            def handler(_name, *args, _m=m):
                return _m.fn(server, *args)
        return handler

    for m in sd.methods.values():
        rpc_server.add(m.name, wrap(m))

    rpc_server.add("get_config", lambda _n: server.get_config())
    rpc_server.add("save", lambda _n, mid: server.save(_to_str(mid)))
    rpc_server.add("load", lambda _n, mid: server.load(_to_str(mid)))
    rpc_server.add("get_status", lambda _n: server.get_status())
    rpc_server.add("clear", lambda _n: server.clear())


# ---------------------------------------------------------------------------
# classifier (server/classifier.idl)
# ---------------------------------------------------------------------------

register_service(ServiceDef("classifier", [
    Method("train",
           lambda s, data: s.driver.train(
               [(_to_str(lbl), _datum(d)) for lbl, d in data]),
           update=True),
    Method("classify",
           lambda s, data: [
               [[lbl, sc] for lbl, sc in row]
               for row in s.driver.classify([_datum(d) for d in data])]),
    Method("get_labels", lambda s: s.driver.get_labels()),
    Method("set_label", lambda s, lbl: s.driver.set_label(_to_str(lbl)),
           update=True),
    Method("delete_label", lambda s, lbl: s.driver.delete_label(_to_str(lbl)),
           update=True),
]))
