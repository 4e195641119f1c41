"""create_mixer: the --mixer name to a mixer (the port's copy of
jubatus_tpu/mix/mixer_factory.py).  A process without a coordinator gets
DummyMixer.  Every peer RPC of a mixer retries with DEFAULT_RETRY, and
its fan-outs share one PeerHealth breaker at its defaults (the JAX CLI's
--rpc_retry_* and --breaker_* flags are not ported).

collective_mixer is refused: it needs the data-parallel tier (the
in-mesh collective fold), which the port does not have yet.
"""

from __future__ import annotations

from jubatus_tpu_torch.mix.linear_mixer import (DummyMixer, LinearMixer,
                                                MixerBase)
from jubatus_tpu_torch.mix.push_mixer import PushMixer

MIXERS = ("linear_mixer", "random_mixer", "broadcast_mixer", "skip_mixer",
          "dummy_mixer")


def check_mixer(name: str) -> None:
    """Raise ValueError, saying why, for a name the port cannot serve."""
    if name == "collective_mixer":
        raise ValueError(
            "collective_mixer needs the data-parallel tier (the in-mesh "
            "collective fold), which jubatus_tpu_torch does not have yet; "
            f"use one of {', '.join(MIXERS)}")
    if name not in MIXERS:
        raise ValueError(f"unknown mixer: {name} (have {', '.join(MIXERS)})")


def create_mixer(name: str, server, membership=None, *,
                 interval_sec: float = 16.0, interval_count: int = 512,
                 rpc_timeout: float = 10.0,
                 quantize: bool = False) -> MixerBase:
    """`quantize` (--mix_quantize) puts the mixer's diff bodies on the
    blockwise-int8 v3 wire; flip it cluster-wide."""
    check_mixer(name)
    if membership is None or name == "dummy_mixer":
        return DummyMixer()
    if name == "linear_mixer":
        return LinearMixer(server, membership, interval_sec=interval_sec,
                           interval_count=interval_count,
                           rpc_timeout=rpc_timeout, quantize=quantize)
    return PushMixer(server, membership, strategy=name.replace("_mixer", ""),
                     interval_sec=interval_sec, interval_count=interval_count,
                     rpc_timeout=rpc_timeout, quantize=quantize)
