"""The WAL root's layout (counterpart of jubatus_tpu/tenancy/; the slot
registry, quotas and multi-slot routing are ROADMAP Queue 1 item 3.5)."""
