"""Quantized MIX payloads (blockwise int8 kernels and their wire form)."""
