"""create_mixer: the --mixer name to a mixer (the port's copy of
jubatus_tpu/mix/mixer_factory.py).  A process without a coordinator gets
DummyMixer.  The fault-tolerance knobs (rpc/resilience.py) are plumbed
here, from the server's flags: `retry` is the RetryPolicy every peer RPC
of the mixer rides (--rpc_retry_max, --rpc_retry_backoff_ms; None
disables retries), and `breaker_threshold` / `breaker_cooldown`
(--breaker_threshold, --breaker_cooldown) parameterize the PeerHealth
breaker its fan-outs share.

collective_mixer is the two-level tier (mix/collective.py): a
CollectiveMixer owning the trigger, with a LinearMixer inside it for the
peers outside this node's mix group.  A driver without replicas to fold
takes the wire tier every round.
"""

from __future__ import annotations

from typing import Optional

from jubatus_tpu_torch.mix.linear_mixer import (DummyMixer, LinearMixer,
                                                MixerBase)
from jubatus_tpu_torch.mix.push_mixer import PushMixer
from jubatus_tpu_torch.rpc.resilience import (DEFAULT_RETRY, PeerHealth,
                                              RetryPolicy)

MIXERS = ("linear_mixer", "collective_mixer", "random_mixer",
          "broadcast_mixer", "skip_mixer", "dummy_mixer")


def check_mixer(name: str) -> None:
    """Raise ValueError, saying why, for a name the port cannot serve."""
    if name not in MIXERS:
        raise ValueError(f"unknown mixer: {name} (have {', '.join(MIXERS)})")


def create_mixer(name: str, server, membership=None, *,
                 interval_sec: float = 16.0, interval_count: int = 512,
                 rpc_timeout: float = 10.0,
                 retry: Optional[RetryPolicy] = DEFAULT_RETRY,
                 breaker_threshold: int = 3,
                 breaker_cooldown: float = 5.0,
                 quantize: bool = False) -> MixerBase:
    """`quantize` (--mix_quantize) puts the mixer's diff bodies on the
    blockwise-int8 v3 wire; flip it cluster-wide."""
    check_mixer(name)
    if membership is None or name == "dummy_mixer":
        return DummyMixer()
    health = PeerHealth(fail_threshold=breaker_threshold,
                        cooldown=breaker_cooldown)
    if name in ("linear_mixer", "collective_mixer"):
        inner = LinearMixer(server, membership, interval_sec=interval_sec,
                            interval_count=interval_count,
                            rpc_timeout=rpc_timeout, retry=retry,
                            health=health, quantize=quantize)
        if name == "linear_mixer":
            return inner
        # the collective tier owns the trigger; the LinearMixer rides in
        # it for the peers outside this node's mix group
        from jubatus_tpu_torch.mix.collective import CollectiveMixer
        return CollectiveMixer(server, membership, inner=inner,
                               interval_sec=interval_sec,
                               interval_count=interval_count)
    return PushMixer(server, membership, strategy=name.replace("_mixer", ""),
                     interval_sec=interval_sec, interval_count=interval_count,
                     rpc_timeout=rpc_timeout, retry=retry, health=health,
                     quantize=quantize)
