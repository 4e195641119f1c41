"""Engine drivers of the port: the classifier, regression and
nearest_neighbor."""

from jubatus_tpu_torch.models.base import (DRIVERS, Driver, RawBatch,
                                           create_driver, register_driver)
from jubatus_tpu_torch.models import classifier  # noqa: F401  (registers)
from jubatus_tpu_torch.models import regression  # noqa: F401  (registers)
from jubatus_tpu_torch.models import nearest_neighbor  # noqa: F401

__all__ = ["DRIVERS", "Driver", "RawBatch", "create_driver",
           "register_driver"]
