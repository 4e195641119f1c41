"""Many model slots in one server process (the port's copy of
jubatus_tpu/tenancy/): the slot registry, the admission plane and the
per-tenant quotas.

  registry.py   SlotState / ModelSlot / SlotRegistry / SlotMixRouter and
                the per-slot cluster join and leave (per-slot MIX groups)
  quotas.py     QuotaSpec / TenantQuotas (the server's authority) /
                ProxyQuotaGate (the edge's early rejection)
  layout.py     the WAL root's layout v2: the version marker, the adoption
                of a legacy single-model dir, the journaled slot catalog

Argument 0 of every RPC (the cluster name the reference carries and
drops) is the slot key, with the default slot for any other name, so
single-model clients and clusters are untouched.  The JAX package's slot
migration (standby slots, activate_model, placement) is its autopilot's,
ROADMAP Queue 1 item 7.
"""

from jubatus_tpu_torch.tenancy.layout import (CATALOG_NAME, LAYOUT_NAME,
                                              LAYOUT_VERSION, load_catalog,
                                              prepare_root, slot_dir,
                                              store_catalog,
                                              validate_slot_name)
from jubatus_tpu_torch.tenancy.quotas import (ProxyQuotaGate, QuotaExceeded,
                                              QuotaSpec, TenantQuotas,
                                              TokenBucket)
from jubatus_tpu_torch.tenancy.registry import (ClusterContext, ModelSlot,
                                                SlotMixRouter, SlotRegistry,
                                                SlotState, join_slot_cluster,
                                                leave_slot_cluster,
                                                peek_frame_model)

__all__ = [
    "CATALOG_NAME", "LAYOUT_NAME", "LAYOUT_VERSION", "ClusterContext",
    "ModelSlot", "ProxyQuotaGate", "QuotaExceeded", "QuotaSpec",
    "SlotMixRouter", "SlotRegistry", "SlotState", "TenantQuotas",
    "TokenBucket", "join_slot_cluster", "leave_slot_cluster",
    "load_catalog", "peek_frame_model", "prepare_root", "slot_dir",
    "store_catalog", "validate_slot_name",
]
