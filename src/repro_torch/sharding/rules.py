"""The sharding context, as far as it means anything on one card: which
attention lowering the layers use. The reference's mesh, logical-axis
rules and sharding constraints have no counterpart on a single device,
so a mesh raises.

The tracking fleet shards by sensor: ``sensor_blocks`` gives each device
of a list its contiguous block of sensors (the counterpart of the
reference's ``sensor_specs``, which maps the banks' sensor axis onto the
mesh data axes).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

ATTN_IMPLS = ("auto", "full", "chunked", "swa", "flash")


@dataclass(frozen=True)
class ShardingContext:
    mesh: Optional[Any] = None
    # attention lowering: auto | full | chunked | swa | flash (prefill on
    # the flash_attention kernel, decode on flash_decode; the others
    # decode on decode_attention, as the reference)
    attn_impl: str = "auto"

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "the port serves on one card: a device mesh is not "
                "supported")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in "
                             f"{ATTN_IMPLS}")


def sensor_blocks(n_sensors: int, devices: Sequence) -> List[Tuple[Any,
                                                                    slice]]:
    """(device, sensors) of each shard: device i of ``devices`` serves the
    contiguous block i of ``n_sensors // len(devices)`` sensors. A device
    may appear more than once (two shards on one card). Raises
    ValueError when the sensors do not divide over the devices."""
    d = len(devices)
    if d == 0 or n_sensors % d:
        raise ValueError(
            f"n_sensors={n_sensors} must divide over the mesh data axes "
            f"(size {d})")
    per = n_sensors // d
    return [(dev, slice(i * per, (i + 1) * per))
            for i, dev in enumerate(devices)]
