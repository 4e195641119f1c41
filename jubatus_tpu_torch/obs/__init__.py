"""Observability plane of the port (counterpart of jubatus_tpu/obs):
request-scoped spans (trace.py) and the HTTP metrics exporter
(exporter.py).

Everything defaults off; the CLIs enable pieces with `--trace_ring`,
`--slow_op_ms`, `--metrics_port`, `--torch_profile` and `--log_format`.
The fleet, heat and health planes (obs/fleet.py, heat.py, health.py of
the JAX package) are ROADMAP Queue 1 item 7."""

from jubatus_tpu_torch.obs.trace import NULL_SPAN, Span, TRACER, Tracer

__all__ = ["NULL_SPAN", "Span", "TRACER", "Tracer", "MetricsExporter"]


def __getattr__(name):
    # the exporter pulls in http.server; keep it off the hot import path
    if name == "MetricsExporter":
        from jubatus_tpu_torch.obs.exporter import MetricsExporter
        return MetricsExporter
    raise AttributeError(name)
