"""Engine drivers of the port: the classifier and regression."""

from jubatus_tpu_torch.models.base import (DRIVERS, Driver, RawBatch,
                                           create_driver, register_driver)
from jubatus_tpu_torch.models import classifier  # noqa: F401  (registers)
from jubatus_tpu_torch.models import regression  # noqa: F401  (registers)

__all__ = ["DRIVERS", "Driver", "RawBatch", "create_driver",
           "register_driver"]
