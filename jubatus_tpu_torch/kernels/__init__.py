"""Build rule and loader of the port's hand-written CUDA kernels
(jubatus_tpu_torch/csrc/)."""
