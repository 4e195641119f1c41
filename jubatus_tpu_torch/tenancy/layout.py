"""The WAL root's layout — its version marker, the adoption of a legacy
single-model directory, and the refusal of a root that holds secondary
model slots (the root-layout half of jubatus_tpu/tenancy/layout.py).

Disk layout under --journal DIR (layout version 2, the JAX package's):

  LAYOUT                  JSON {"layout_version": 2} — stamped at boot;
                          its presence marks a tenancy-aware root
  MODELS.json             the JAX package's slot catalog: every admitted
                          secondary model.  The port serves one model a
                          process, so it refuses to boot on a root whose
                          catalog lists any (it would start and silently
                          drop them); multi-slot serving is ROADMAP
                          Queue 1 item 3.5
  MANIFEST,
  journal-*.wal,
  snapshot-*.jubatus      the default slot's namespace — byte for byte
                          the single-model layout, so a legacy WAL dir is
                          adopted as the default slot's namespace by
                          construction (one-way: once LAYOUT is stamped
                          the dir is v2 for good)
  slots/<name>/           secondary slots' namespaces (JAX package only)

Adoption is detection plus the stamp, never a byte rewrite: a crash
mid-adoption loses nothing (the stamp is re-attempted next boot).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

log = logging.getLogger("jubatus_tpu_torch.tenancy")

LAYOUT_NAME = "LAYOUT"
CATALOG_NAME = "MODELS.json"
SLOTS_DIRNAME = "slots"
LAYOUT_VERSION = 2
CATALOG_VERSION = 1


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
    layout, and on a catalog that lists secondary slots."""
    from jubatus_tpu_torch.durability import fsync_dir, write_file_durably
    os.makedirs(root, exist_ok=True)
    slots = load_catalog(root)
    if slots:
        names = ", ".join(str(m.get("name", "?")) for m in slots)
        raise RuntimeError(
            f"journal root {root!r} lists secondary model slots ({names}) "
            "in its MODELS.json; this server hosts one model a process and "
            "would drop them — multi-slot serving is ROADMAP Queue 1 item "
            "3.5.  Serve this root with the JAX package's server")
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


def load_catalog(root: str) -> List[Dict[str, Any]]:
    """The secondary models a JAX server admitted on this root, oldest
    first.  A torn/unreadable or unknown-version catalog logs loudly and
    lists nothing, as the JAX package's does."""
    path = os.path.join(root, CATALOG_NAME)
    try:
        with open(path) as fp:
            obj = json.load(fp)
    except FileNotFoundError:
        return []
    except (OSError, ValueError):
        log.error("unreadable slot catalog %s; no secondary slot is "
                  "listed", path, exc_info=True)
        return []
    if obj.get("version") != CATALOG_VERSION:
        log.error("slot catalog version %r unsupported; ignoring it",
                  obj.get("version"))
        return []
    return list(obj.get("models", []))
