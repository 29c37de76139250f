"""Tile table of the katana_bank kernels.

``lane_tile`` (tracks or lanes a block: csrc/scan.cu, imm_step.cu,
imm_scan.cu) and ``time_chunk`` (frames a launch of the replay scans)
are launch choices that leave every result bit for bit what it is: a
thread computes its own lane whatever the block around it, and a chunk
boundary carries x, P (and mu) through device memory unchanged. Which
pair is fastest depends on the kernel, the bank size and the card, so
the measured best is kept in a checked-in table, ``tuned.json`` beside
this module, and the ops wrappers consult it when a caller leaves
``lane_tile`` / ``time_chunk`` at 0.

Table format (the JAX package's, so either package reads the other's
file):

    {"format": 1,
     "entries": {
       "<kernel>": {
         "<key>": [
            {"N": 1024, "lane_tile": 128, "time_chunk": 4096,
             "us_per_frame": 3.1}, ...]}}}

The key names the device a row was measured on (``device_key``):
``"cuda/<torch.cuda.get_device_name>"`` for a card, ``"cpu/plain"`` for
the plain versions on the CPU, so a row measured on one card never
drives another. Lookup: the key must match exactly, then the row of the
nearest ``N`` in log space wins; ``N`` None or <= 0 takes the first
row. A missing table, one that does not parse, another format or an
unknown kernel gives ``{}`` and the static defaults apply, so deleting
the table changes no result, only the launch shape.
``python -m repro_torch.kernels.katana_bank.tune`` regenerates it.
"""
from __future__ import annotations

import functools
import json
import math
import pathlib
from typing import Dict, Optional, Union

import torch

TUNED_PATH = pathlib.Path(__file__).with_name("tuned.json")
TABLE_FORMAT = 1

# the launch shapes the kernels had before the table: a missing row
# changes no launch. katana_imm_sequence's tile counts tracks a block of
# imm_scan.cu (K threads each); the others count tracks or lanes a block.
STATIC_DEFAULTS = {
    "katana_bank": dict(lane_tile=128),
    "katana_bank_imm": dict(lane_tile=128),
    "imm_bank_sequence": dict(lane_tile=128),
    "katana_bank_sequence": dict(lane_tile=128, time_chunk=4096),
    "katana_imm_sequence": dict(lane_tile=32, time_chunk=4096),
}

Key = Union[str, torch.device, None]


@functools.lru_cache(maxsize=None)
def _card_key(index: int) -> str:
    return f"cuda/{torch.cuda.get_device_name(index)}"


def device_key(device) -> str:
    """The table key of ``device``: ``"cuda/<card name>"`` or
    ``"cpu/plain"``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu/plain"
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _card_key(torch.cuda.current_device() if dev.index is None
                     else dev.index)


def _key(key: Key) -> str:
    """A table key as given ("backend/mode"), or the key of a device;
    None: the card when there is one, else the CPU."""
    if key is None:
        key = "cuda" if torch.cuda.is_available() else "cpu"
    if isinstance(key, str) and "/" in key:
        return key
    return device_key(key)


@functools.lru_cache(maxsize=8)
def _load_table(path_str: str) -> Dict:
    path = pathlib.Path(path_str)
    if not path.exists():
        return {}
    try:
        table = json.loads(path.read_text())
    except (OSError, ValueError):
        return {}
    if not isinstance(table, dict) or table.get("format") != TABLE_FORMAT:
        return {}
    return table.get("entries", {})


def clear_cache() -> None:
    """Drop the cached table (a rewritten file is read anew)."""
    _load_table.cache_clear()


def best_config(kernel: str, N: Optional[int] = None, key: Key = None,
                path: Optional[pathlib.Path] = None) -> Dict:
    """The tabled {lane_tile, time_chunk, ...} row of ``kernel`` at bank
    size ``N`` under ``key`` (a table key such as ``"cuda/NVIDIA H100
    80GB HBM3"``, or a device; None: the card if there is one), or {}
    when the table has nothing for it."""
    entries = _load_table(str(path or TUNED_PATH))
    rows = entries.get(kernel, {}).get(_key(key), [])
    if not rows:
        return {}
    if N is None or N <= 0:
        return dict(rows[0])
    # nearest bank size in log space: the best tile moves with the
    # bank's scale, not its difference
    best = min(rows, key=lambda r: abs(math.log(max(r.get("N", 1), 1))
                                       - math.log(max(N, 1))))
    return dict(best)


def tuned_lane_tile(kernel: str, N: Optional[int], default: int,
                    key: Key = None) -> int:
    cfg = best_config(kernel, N, key)
    return int(cfg.get("lane_tile", 0)) or default


def tuned_time_chunk(kernel: str, N: Optional[int], default: int,
                     key: Key = None) -> int:
    cfg = best_config(kernel, N, key)
    return int(cfg.get("time_chunk", 0)) or default


def write_table(entries: Dict, path: Optional[pathlib.Path] = None) -> None:
    """Write an entries dict (``tune.tune`` builds one) as a table and
    drop the lookup cache, so the new rows apply."""
    path = pathlib.Path(path or TUNED_PATH)
    path.write_text(json.dumps(
        dict(format=TABLE_FORMAT,
             note=("measured best lane_tile/time_chunk per (kernel, bank "
                   "size, device); regenerate with `python -m "
                   "repro_torch.kernels.katana_bank.tune`"),
             entries=entries), indent=2, sort_keys=True) + "\n")
    clear_cache()
