"""The WAL root's layout: its version marker, the adoption of a legacy
single-model directory, and the journaled slot catalog (the port's copy
of jubatus_tpu/tenancy/layout.py, so either package recovers a root the
other wrote).

Disk layout under --journal DIR (layout version 2):

  LAYOUT                  JSON {"layout_version": 2}, stamped at boot;
                          its presence marks a tenancy-aware root
  MODELS.json             the slot catalog: every admitted secondary model
                          (name, tenant, config, quota), written durably on
                          create_model / drop_model so the slots survive a
                          crash and rejoin their MIX groups at the next boot
  MANIFEST,
  journal-*.wal,
  snapshot-*.jubatus      the default slot's namespace, byte for byte the
                          single-model layout, so a legacy WAL dir is
                          adopted as the default slot's namespace by
                          construction (one-way: once LAYOUT is stamped the
                          dir is v2 for good)
  slots/<name>/           one namespace a secondary slot, each with its own
                          MANIFEST, journal segments, snapshots and LOCK

Adoption is detection plus the stamp, never a byte rewrite: a crash
mid-adoption loses nothing (the stamp is re-attempted next boot).

MIGRATION.json is the JAX autopilot's slot-migration record (ROADMAP
Queue 1 item 7).  The port does not resume a migration, so it refuses to
boot on a root that holds one.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Any, Dict, List, Optional

log = logging.getLogger("jubatus_tpu_torch.tenancy")

LAYOUT_NAME = "LAYOUT"
CATALOG_NAME = "MODELS.json"
MIGRATION_NAME = "MIGRATION.json"
SLOTS_DIRNAME = "slots"
LAYOUT_VERSION = 2
CATALOG_VERSION = 1

# slot names are path components and wire keys.  The default slot's name
# (the cluster name) is exempt: its namespace is the root itself
SLOT_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]{0,127}$")


def validate_slot_name(name: str) -> str:
    if not SLOT_NAME_RE.match(name or ""):
        raise ValueError(
            f"invalid model name {name!r}: want [A-Za-z0-9][A-Za-z0-9_.-]*"
            " (max 128 chars)")
    return name


def slot_dir(root: str, name: str) -> str:
    return os.path.join(root, SLOTS_DIRNAME, validate_slot_name(name))


def _looks_like_legacy_wal(root: str) -> bool:
    """A single-model journal dir: journal segments / MANIFEST /
    snapshots at the top level with no LAYOUT marker."""
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return False
    return any(n == "MANIFEST" or n.startswith("journal-")
               or (n.startswith("snapshot-") and n.endswith(".jubatus"))
               for n in names)


def read_layout_version(root: str) -> Optional[int]:
    try:
        with open(os.path.join(root, LAYOUT_NAME)) as fp:
            return int(json.load(fp).get("layout_version", 0))
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        log.warning("unreadable LAYOUT marker in %s; re-stamping", root,
                    exc_info=True)
        return None


def prepare_root(root: str) -> bool:
    """Bring a WAL root to layout v2.  Returns True when a legacy
    single-model dir was detected and adopted (the one-way migration);
    idempotent for already-stamped and fresh roots.  Raises on a newer
    layout, and on a root that holds a slot-migration record."""
    from jubatus_tpu_torch.durability import fsync_dir, write_file_durably
    os.makedirs(root, exist_ok=True)
    if os.path.exists(os.path.join(root, MIGRATION_NAME)):
        raise RuntimeError(
            f"journal root {root!r} holds a slot-migration record "
            f"({MIGRATION_NAME}); finishing or rolling back a migration is "
            "the autopilot's, ROADMAP Queue 1 item 7, which is not in the "
            "port yet.  Boot this root once with the JAX package's server")
    ver = read_layout_version(root)
    if ver is not None:
        if ver > LAYOUT_VERSION:
            raise RuntimeError(
                f"journal root {root!r} has layout_version {ver}; this "
                f"binary speaks <= {LAYOUT_VERSION} — refusing to write")
        return False
    migrated = _looks_like_legacy_wal(root)
    marker = {"layout_version": LAYOUT_VERSION}
    if migrated:
        # the provenance: an upgraded-in-place root reads apart from a
        # born-v2 one
        marker["migrated_from"] = 1
        log.info("adopting legacy single-model journal dir %s as the "
                 "default slot's namespace (layout v%d stamp)", root,
                 LAYOUT_VERSION)
    write_file_durably(os.path.join(root, LAYOUT_NAME),
                       lambda fp: fp.write(json.dumps(marker).encode()))
    os.makedirs(os.path.join(root, SLOTS_DIRNAME), exist_ok=True)
    fsync_dir(root)
    return migrated


# -- slot catalog ------------------------------------------------------------


def catalog_path(root: str) -> str:
    return os.path.join(root, CATALOG_NAME)


def load_catalog(root: str) -> List[Dict[str, Any]]:
    """The admitted secondary models, oldest first.  A torn or unreadable
    catalog logs loudly and restores nothing: the default slot still
    recovers, and re-creating the lost slots re-adopts their journal
    namespaces (untouched on disk)."""
    try:
        with open(catalog_path(root)) as fp:
            obj = json.load(fp)
    except FileNotFoundError:
        return []
    except (OSError, ValueError):
        log.error("unreadable slot catalog %s; secondary slots will NOT "
                  "be restored this boot (their journal namespaces are "
                  "intact — re-create_model to re-adopt them)",
                  catalog_path(root), exc_info=True)
        return []
    if obj.get("version") != CATALOG_VERSION:
        log.error("slot catalog version %r unsupported; ignoring it",
                  obj.get("version"))
        return []
    return list(obj.get("models", []))


def store_catalog(root: str, models: List[Dict[str, Any]]) -> None:
    """Durably replace the catalog, the journal of admission: a create or
    drop is crash-safe once this returns (tmp + fsync + rename + dir
    fsync, the snapshots' publish)."""
    from jubatus_tpu_torch.durability import write_file_durably
    payload = json.dumps({"version": CATALOG_VERSION, "models": models},
                         indent=1).encode()
    write_file_durably(catalog_path(root), lambda fp: fp.write(payload))
