"""Host-side utilities of the port."""


def to_bytes(x) -> bytes:
    """Binary that crossed the old-spec wire as raw arrives decoded as a
    surrogate-escaped str: back to the exact bytes."""
    return x.encode("utf-8", "surrogateescape") if isinstance(x, str) else x
