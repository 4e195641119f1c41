"""Feature-vector conversion: datum -> hashed sparse vector (the port's own
copy of jubatus_tpu/fv, pure-Python path), with the dynamic plugin
loader (plugin.py) installed."""

from jubatus_tpu_torch.fv import plugin as _plugin  # the "dynamic" method
from jubatus_tpu_torch.fv.config import ConverterConfig
from jubatus_tpu_torch.fv.converter import DatumToFVConverter, SparseBatch
from jubatus_tpu_torch.fv.datum import Datum

__all__ = ["Datum", "ConverterConfig", "DatumToFVConverter", "SparseBatch"]
