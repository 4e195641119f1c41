"""Cluster membership over the coordination service (the port's copy of
jubatus_tpu/cluster/membership.py; the same paths, so port and JAX
servers see each other).

  /jubatus/actors/<type>/<name>/nodes/<ip>_<port>       (all actors)
  /jubatus/actors/<type>/<name>/actives/<ip>_<port>     (mix-fresh actors)
  /jubatus/actors/<type>/<name>/mix_groups/<group>~<ip>_<port>
                                                        (collective MIX groups)
  /jubatus/actors/<type>/<name>/master_lock             (MIX master election)
  /jubatus/config/<type>/<name>                         (cluster config)

Actor registrations are EPHEMERAL: they vanish when the owning session
stops heartbeating.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from jubatus_tpu_torch.cluster.lock_service import (
    CachedMembership, CoordLockService, LockServiceBase,
    create_or_replace_ephemeral)

log = logging.getLogger("jubatus_tpu_torch.membership")

JUBATUS_BASE = "/jubatus"
ACTOR_BASE = JUBATUS_BASE + "/actors"
PROXY_BASE = JUBATUS_BASE + "/jubaproxies"   # proxies' ephemeral entries
CONFIG_BASE = JUBATUS_BASE + "/config"

MEMBERS_TTL_S = 1.0     # how long get_all_nodes may answer from its cache


def build_loc_str(ip: str, port: int) -> str:
    return f"{ip}_{port}"


def revert_loc_str(loc: str) -> Tuple[str, int]:
    ip, port = loc.rsplit("_", 1)
    return ip, int(port)


def decode_loc_strs(members: List[str], where: str) -> List[Tuple[str, int]]:
    """Decode node names, skipping (with a warning) any that do not
    parse, so one malformed name cannot break every MIX fan-out."""
    out: List[Tuple[str, int]] = []
    for m in members:
        try:
            out.append(revert_loc_str(m))
        except ValueError:
            log.warning("skipping undecodable node name %r in %s", m, where)
    return out


def actor_node_dir(engine_type: str, name: str) -> str:
    return f"{ACTOR_BASE}/{engine_type}/{name}/nodes"


def actor_active_dir(engine_type: str, name: str) -> str:
    return f"{ACTOR_BASE}/{engine_type}/{name}/actives"


def config_path(engine_type: str, name: str) -> str:
    return f"{CONFIG_BASE}/{engine_type}/{name}"


def mix_group_dir(engine_type: str, name: str) -> str:
    """The groups of the two-level MIX (mix/collective.py): each entry
    `<group>~<ip>_<port>`; nodes sharing a group reconcile by the
    collective fold, every other peer needs a wire (linear mixer) leg."""
    return f"{ACTOR_BASE}/{engine_type}/{name}/mix_groups"


class MembershipClient:
    """One server process's view of, and registration in, the cluster.
    `coordinator` is a lock service or a connect string."""

    def __init__(self, coordinator, engine_type: str, name: str):
        if isinstance(coordinator, LockServiceBase):
            self.ls: LockServiceBase = coordinator
        else:
            self.ls = CoordLockService(coordinator)
        self.engine_type = engine_type
        self.name = name
        self._nodes = CachedMembership(
            self.ls, actor_node_dir(engine_type, name), ttl=MEMBERS_TTL_S)
        self._mix_groups = CachedMembership(
            self.ls, mix_group_dir(engine_type, name), ttl=MEMBERS_TTL_S)

    # -- registration -------------------------------------------------------

    def _register(self, path: str) -> None:
        if not create_or_replace_ephemeral(self.ls, path):
            raise RuntimeError(f"cannot register {path}")

    def register_actor(self, ip: str, port: int) -> None:
        self._register(f"{actor_node_dir(self.engine_type, self.name)}/"
                       f"{build_loc_str(ip, port)}")

    def register_active(self, ip: str, port: int) -> None:
        self._register(f"{actor_active_dir(self.engine_type, self.name)}/"
                       f"{build_loc_str(ip, port)}")

    def unregister_active(self, ip: str, port: int) -> None:
        self.ls.remove(f"{actor_active_dir(self.engine_type, self.name)}/"
                       f"{build_loc_str(ip, port)}")

    def unregister_actor(self, ip: str, port: int) -> None:
        """Explicit withdrawal (a dropped model slot): the registration is
        an ephemeral of the still-alive process session, so it must be
        removed, not abandoned."""
        self.ls.remove(f"{actor_node_dir(self.engine_type, self.name)}/"
                       f"{build_loc_str(ip, port)}")

    def register_mix_group(self, group: str, ip: str, port: int) -> None:
        """Advertise this node's collective MIX group (ephemeral, like
        every actor registration).  `group` may not contain '~', which
        separates it from the location in the entry's name."""
        if "~" in group:
            raise ValueError(f"mix group id may not contain '~': {group!r}")
        self._register(f"{mix_group_dir(self.engine_type, self.name)}/"
                       f"{group}~{build_loc_str(ip, port)}")

    # -- queries ------------------------------------------------------------

    def get_all_nodes(self, force: bool = False) -> List[Tuple[str, int]]:
        """Every registered actor; from a cache up to MEMBERS_TTL_S old
        unless `force` reads the coordinator now."""
        return decode_loc_strs(self._nodes.members(force=force), "nodes")

    def get_mix_groups(self) -> dict:
        """{group: [(ip, port), ...]} of every advertised node.  A node
        that advertises none (a server without the collective tier) is
        in no group, which sends a round over the wire."""
        out: dict = {}
        for m in self._mix_groups.members():
            if "~" not in m:
                log.warning("skipping undecodable mix_group entry %r", m)
                continue
            group, loc = m.split("~", 1)
            try:
                out.setdefault(group, []).append(revert_loc_str(loc))
            except ValueError:
                log.warning("skipping undecodable mix_group entry %r", m)
        return out

    # -- cluster config -----------------------------------------------------

    def set_config(self, config: str) -> None:
        self.ls.set(config_path(self.engine_type, self.name), config.encode())

    def get_config(self) -> Optional[str]:
        raw = self.ls.get(config_path(self.engine_type, self.name))
        return None if raw is None else raw.decode()

    # -- MIX master lock and ids ----------------------------------------------

    def master_lock(self):
        return self.ls.lock(
            f"{ACTOR_BASE}/{self.engine_type}/{self.name}/master_lock")

    def create_id(self) -> int:
        return self.ls.create_id(f"{self.engine_type}/{self.name}")

    def close(self) -> None:
        self.ls.close()
