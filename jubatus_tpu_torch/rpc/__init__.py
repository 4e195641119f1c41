"""msgpack-RPC server and client of the port (old-spec wire)."""
