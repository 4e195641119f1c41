"""Feature-vector conversion: datum -> hashed sparse vector (the port's own
copy of jubatus_tpu/fv, pure-Python path)."""

from jubatus_tpu_torch.fv.config import ConverterConfig
from jubatus_tpu_torch.fv.converter import DatumToFVConverter, SparseBatch
from jubatus_tpu_torch.fv.datum import Datum

__all__ = ["Datum", "ConverterConfig", "DatumToFVConverter", "SparseBatch"]
