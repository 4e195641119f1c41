"""Engine drivers of the port: the classifier (with its NN method),
regression, nearest_neighbor, recommender and anomaly."""

from jubatus_tpu_torch.models.base import (DRIVERS, Driver, RawBatch,
                                           create_driver, register_driver)
from jubatus_tpu_torch.models import classifier  # noqa: F401  (registers)
from jubatus_tpu_torch.models import regression  # noqa: F401  (registers)
from jubatus_tpu_torch.models import nearest_neighbor  # noqa: F401
from jubatus_tpu_torch.models import recommender  # noqa: F401
from jubatus_tpu_torch.models import anomaly  # noqa: F401

__all__ = ["DRIVERS", "Driver", "RawBatch", "create_driver",
           "register_driver"]
