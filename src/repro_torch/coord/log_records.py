"""Typed control-plane records packed into the consensus log's (key,val)
(a copy of `repro.coord.log_records`: the port imports nothing of the
JAX package, not even its framework-free modules).

The jitted state machine stores int32 (key, value) pairs; control records
reserve the top of the key space:  key = RECORD_BASE + record_type, value
packs the payload.  The KV data plane hashes user keys below RECORD_BASE.
"""
from __future__ import annotations

import dataclasses
from enum import IntEnum


class RecordType(IntEnum):
    CKPT_COMMIT = 0        # value = step*2**12 | digest12
    MEMBERSHIP = 1         # value = alive-pods bitmap (<= 30 pods)
    SCALE = 2              # value = k_s*2**10 | k_o
    STRAGGLER = 3          # value = pod id reassigned
    EPOCH_MARK = 4


RECORD_BASE_FRACTION = 0.9375   # top 1/16 of key space is control records


def record_base(key_space: int) -> int:
    return int(key_space * RECORD_BASE_FRACTION)


def pack_ckpt(step: int, digest_hex: str) -> int:
    d12 = int(digest_hex[:3], 16)           # 12-bit digest tag
    return (step & 0x3FFFF) * 4096 + d12


def unpack_ckpt(value: int):
    return value // 4096, value % 4096


def pack_scale(k_s: int, k_o: int) -> int:
    return (k_s & 0x3FF) * 1024 + (k_o & 0x3FF)


def unpack_scale(value: int):
    return value // 1024, value % 1024


def pack_membership(alive_bitmap: int) -> int:
    return alive_bitmap & 0x3FFFFFFF


@dataclasses.dataclass(frozen=True)
class ControlRecord:
    rtype: RecordType
    value: int

    def key(self, key_space: int) -> int:
        return record_base(key_space) + int(self.rtype)
