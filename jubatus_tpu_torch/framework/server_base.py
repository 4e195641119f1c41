"""The port's per-process model host (counterpart of
jubatus_tpu/framework/server_base.py, one model per process).

It builds the engine's driver on its device, counts updates, and answers
the common RPCs: get_config, save, load, clear and get_status.  Model
files use the reference format (framework/save_load.py) with the JAX
package's naming and user-data version, so a file saved by either package
loads in the other.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

import jubatus_tpu_torch
from jubatus_tpu_torch.device import device_telemetry
from jubatus_tpu_torch.framework.save_load import load_model, save_model
from jubatus_tpu_torch.models import create_driver
from jubatus_tpu_torch.models.classifier import train_scan
from jubatus_tpu_torch.parallel.quantized import (dequantize_int8,
                                                  quantize_int8)

USER_DATA_VERSION = 1

# every kernel wrapper of the port, by the name get_status reports
KERNEL_WRAPPERS = {
    "train_scan": train_scan,
    "quantize_int8": quantize_int8,
    "dequantize_int8": dequantize_int8,
}


def kernel_launches() -> Dict[str, int]:
    """Launch counters of every kernel wrapper in this process."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_kernel_launches() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


@dataclass
class ServerArgs:
    """CLI surface (a subset of the JAX server's ServerArgs)."""
    type: str = ""
    name: str = ""
    rpc_port: int = 9199
    bind_address: str = "127.0.0.1"
    datadir: str = "/tmp"
    configpath: str = ""
    eth: str = ""                # advertised address override
    device: str = "cuda"


class JubatusServer:
    def __init__(self, args: ServerArgs, config: Optional[str] = None):
        if config is None:
            with open(args.configpath) as f:
                config = f.read()
        self.args = args
        self.config_str = config
        self.driver = create_driver(args.type, json.loads(config),
                                    device=args.device)
        self.update_count = 0
        self.start_time = time.time()
        # the advertised address: --eth, else the bind address (a
        # wildcard bind advertises loopback)
        self.ip = args.eth or (args.bind_address
                               if args.bind_address not in ("", "0.0.0.0")
                               else "127.0.0.1")

    @property
    def server_id(self) -> str:
        return f"{self.ip}_{self.args.rpc_port}"

    def event_model_updated(self) -> None:
        self.update_count += 1

    def get_config(self) -> str:
        return self.config_str

    def _model_path(self, model_id: str) -> str:
        return os.path.join(
            self.args.datadir,
            f"{self.server_id}_jubatus_{self.args.type}_"
            f"{self.args.name}_{model_id}.jubatus")

    def save(self, model_id: str) -> Dict[str, str]:
        if not model_id or "/" in model_id:
            raise ValueError(f"invalid model id: {model_id!r}")
        path = self._model_path(model_id)
        data = self.driver.pack()
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as fp:
            save_model(fp, server_type=self.args.type, model_id=model_id,
                       config=self.config_str,
                       user_data_version=USER_DATA_VERSION, driver_data=data)
            fp.flush()
            os.fsync(fp.fileno())
        os.replace(tmp, path)
        return {self.server_id: path}

    def load(self, model_id: str) -> bool:
        if not model_id or "/" in model_id:
            raise ValueError(f"invalid model id: {model_id!r}")
        with open(self._model_path(model_id), "rb") as fp:
            data = load_model(fp, server_type=self.args.type,
                              expected_config=self.config_str,
                              user_data_version=USER_DATA_VERSION)
        self.driver.unpack(data)
        self.event_model_updated()
        return True

    def clear(self) -> bool:
        self.driver.clear()
        self.event_model_updated()
        return True

    def get_status(self) -> Dict[str, Dict[str, str]]:
        st: Dict[str, str] = {
            "type": self.args.type,
            "name": self.args.name,
            "datadir": self.args.datadir,
            "update_count": str(self.update_count),
            "uptime": str(int(time.time() - self.start_time)),
            "pid": str(os.getpid()),
            "version": jubatus_tpu_torch.__version__,
            "is_standalone": "1",
            "device": str(self.driver.device),
        }
        for name, n in kernel_launches().items():
            st[f"kernel_launches.{name}"] = str(n)
        for k, v in device_telemetry(self.driver.device).items():
            st[k] = str(v)
        st.update(self.driver.get_status())
        return {self.server_id: st}
