"""The data-parallel tier and the quantized MIX payloads: replica layouts
(mesh.py), the collective fold of stacked replicas (collective.py), the
blockwise int8 kernels with their wire form and in-process ring
(quantized.py) and the data-parallel drivers (dp.py)."""
