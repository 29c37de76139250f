"""The sharding context, as far as it means anything on one card: which
attention lowering the layers use. The reference's mesh, logical-axis
rules and sharding constraints have no counterpart on a single device,
so a mesh raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

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
