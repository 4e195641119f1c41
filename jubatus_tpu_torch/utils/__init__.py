"""Host-side utilities of the port."""


def to_str(x) -> str:
    """Wire and msgpack values that may arrive as bytes -> str."""
    return x.decode() if isinstance(x, bytes) else x


def to_bytes(x) -> bytes:
    """Binary that crossed the old-spec wire as raw arrives decoded as a
    surrogate-escaped str: back to the exact bytes."""
    return x.encode("utf-8", "surrogateescape") if isinstance(x, str) else x
