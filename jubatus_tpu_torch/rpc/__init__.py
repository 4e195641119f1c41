"""msgpack-RPC server of the port (old-spec wire)."""
