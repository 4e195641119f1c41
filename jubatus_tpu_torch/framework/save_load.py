"""Model file save/load — byte-compatible with the reference format (the
port's copy of jubatus_tpu/framework/save_load.py: a file saved by either
package loads in the other).

Layout (from Jubatus's server/framework/save_load.cpp):

  offset  size  field
  0       8     magic "jubatus\\0"
  8       8     format_version (u64 BE) = 1
  16      4     jubatus version major (u32 BE)
  20      4     jubatus version minor (u32 BE)
  24      4     jubatus version maintenance (u32 BE)
  28      4     crc32 (u32 BE) over header[0:28] + header[32:48] + system + user
  32      8     system_data size (u64 BE)
  40      8     user_data size (u64 BE)
  48      -     system_data: msgpack [version, timestamp, type, id, config]
  -       -     user_data:   msgpack [user_data_version, driver_data]

CRC is the standard zlib polynomial (reference common/crc32.cpp uses
0xEDB88320 with pre/post inversion == zlib.crc32 chaining).

Load validates magic, format version, jubatus version, crc, system-data
version, server type, and config equivalence (JSON-normalized compare),
mirroring save_load.cpp:160-286.
"""

from __future__ import annotations

import json
import struct
import time
from typing import Any, BinaryIO, Tuple

from zlib import crc32

import msgpack

import jubatus_tpu_torch

MAGIC = b"jubatus\x00"
FORMAT_VERSION = 1
SYSTEM_DATA_VERSION = 1


class ModelFileError(RuntimeError):
    pass


def _version_tuple() -> Tuple[int, int, int]:
    return (jubatus_tpu_torch.VERSION_MAJOR, jubatus_tpu_torch.VERSION_MINOR,
            jubatus_tpu_torch.VERSION_MAINTENANCE)


def _calc_crc(header: bytes, system: bytes, user: bytes) -> int:
    c = crc32(header[:28])
    c = crc32(header[32:48], c)
    c = crc32(system, c)
    c = crc32(user, c)
    return c & 0xFFFFFFFF


def _normalize_config(cfg: str) -> str:
    try:
        return json.dumps(json.loads(cfg), sort_keys=True, separators=(",", ":"))
    except Exception:
        return cfg


def save_model(fp: BinaryIO, *, server_type: str, model_id: str, config: str,
               user_data_version: int, driver_data: Any) -> None:
    system = msgpack.packb(
        [SYSTEM_DATA_VERSION, int(time.time()), server_type, model_id, config],
        use_bin_type=True)
    user = msgpack.packb([user_data_version, driver_data], use_bin_type=True)

    major, minor, maint = _version_tuple()
    head = bytearray(48)
    head[0:8] = MAGIC
    struct.pack_into(">Q", head, 8, FORMAT_VERSION)
    struct.pack_into(">III", head, 16, major, minor, maint)
    struct.pack_into(">QQ", head, 32, len(system), len(user))
    struct.pack_into(">I", head, 28, _calc_crc(bytes(head), system, user))

    fp.write(bytes(head))
    fp.write(system)
    fp.write(user)


def load_model(fp: BinaryIO, *, server_type: str, expected_config: str,
               user_data_version: int, check_config: bool = True) -> Any:
    """Validate and return the driver_data payload."""
    head = fp.read(48)
    if len(head) < 48:
        # an empty/short file whose bytes are a prefix of a valid header
        # is a TRUNCATED model (the crash-after-rename failure mode),
        # not a foreign format — the operator fix differs (restore a
        # snapshot/backup vs "you pointed at the wrong file")
        if head == MAGIC[:len(head)] or (len(head) >= 8
                                         and head[0:8] == MAGIC):
            raise ModelFileError(
                f"model file truncated: {len(head)} byte header, "
                "expected 48")
        raise ModelFileError("invalid file format")
    if head[0:8] != MAGIC:
        raise ModelFileError("invalid file format")
    (fmt,) = struct.unpack_from(">Q", head, 8)
    if fmt != FORMAT_VERSION:
        raise ModelFileError(f"invalid format version: {fmt}, expected {FORMAT_VERSION}")
    major, minor, maint = struct.unpack_from(">III", head, 16)
    if (major, minor, maint) != _version_tuple():
        raise ModelFileError(
            f"jubatus version mismatched: {major}.{minor}.{maint}, "
            f"expected {jubatus_tpu_torch.__version__}")
    (crc_expected,) = struct.unpack_from(">I", head, 28)
    system_size, user_size = struct.unpack_from(">QQ", head, 32)
    system = fp.read(system_size)
    user = fp.read(user_size)
    if len(system) < system_size or len(user) < user_size:
        # a short read would otherwise flow straight into the CRC and
        # masquerade as "invalid crc32 checksum" — report what actually
        # happened so a torn tail is distinguishable from bit rot
        raise ModelFileError(
            f"model file truncated: expected "
            f"{48 + system_size + user_size} bytes, got "
            f"{48 + len(system) + len(user)}")
    if _calc_crc(head, system, user) != crc_expected:
        raise ModelFileError("invalid crc32 checksum")

    try:
        sys_obj = msgpack.unpackb(system, raw=False, strict_map_key=False)
        version, _timestamp, typ, _mid, config = sys_obj
    except Exception as e:
        raise ModelFileError("system data is broken") from e
    if version != SYSTEM_DATA_VERSION:
        raise ModelFileError(f"invalid system data version: {version}")
    if typ != server_type:
        raise ModelFileError(f"server type mismatched: {typ}, expected {server_type}")
    if check_config and _normalize_config(config) != _normalize_config(expected_config):
        raise ModelFileError("server config mismatched")

    try:
        user_obj = msgpack.unpackb(user, raw=False, strict_map_key=False)
        udv, driver_data = user_obj
    except Exception as e:
        raise ModelFileError("user data is broken") from e
    if udv != user_data_version:
        raise ModelFileError(
            f"user data version mismatched: {udv}, expected {user_data_version}")
    return driver_data
