"""Coordination of the port's servers: the coordinator service, the
lock-service clients and cluster membership (wire-compatible with
jubatus_tpu/cluster/ both ways)."""
