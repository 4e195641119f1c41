"""Engine drivers of the port (slice 1: the classifier)."""

from jubatus_tpu_torch.models.base import (DRIVERS, Driver, RawBatch,
                                           create_driver, register_driver)
from jubatus_tpu_torch.models import classifier  # noqa: F401  (registers)

__all__ = ["DRIVERS", "Driver", "RawBatch", "create_driver",
           "register_driver"]
