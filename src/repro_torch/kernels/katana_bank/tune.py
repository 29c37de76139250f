"""Tile tuner of the katana_bank kernels: race every instantiated
``lane_tile`` (and, for the replay scans, ``time_chunk``) per (kernel,
bank size) on this device and write the winners to the tile table the
ops wrappers consult (``tuned.json`` beside ``autotune.py``, which holds
the format and the lookup rules).

    python -m repro_torch.kernels.katana_bank.tune [--Ns 1024,8192,131072]
        [--T 300] [--rounds 5] [--out PATH] [--dry-run] [--device cuda]

Rows are keyed by the device (``autotune.device_key``: the card's name),
so a table tuned on one card only ever drives that card; a run on
another card adds its rows beside them. The candidates of one (kernel,
N) are timed in alternating order within one process (forward, then
backward, ``rounds`` times), each time by CUDA events around calls queued
behind a device spin, and the median of the rounds is kept, in µs a
frame (``us_per_frame``; a bank step is one frame). A candidate that
raises is skipped. Every row also keeps the static default's time
(``static_us_per_frame``), so the table says what it gained. Without a
card the tuner refuses to run unless ``--device cpu`` is given (the host
clock then times the plain versions, which ignore the tile).
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.filters import get_filter, make_imm
from repro_torch.kernels.katana_bank import autotune as table_lib
from repro_torch.kernels.katana_bank import ops

KERNELS = ("katana_bank", "katana_bank_sequence", "katana_imm_sequence")
# frames a launch raced for both scans: the reference's IMM fallback (the
# TPU's VMEM bound), half the 300-frame stream, and a whole stream
TIME_CHUNKS = (64, 150, 4096)
# device time a timing should span, so the events' resolution is noise
_TARGET_MS = 2.0


def candidates(kernel: str) -> List[Dict]:
    """Every instantiated tile of ``kernel`` (x every chunk for a scan)."""
    tiles = ops.LANE_TILES[kernel]
    if kernel == "katana_bank":
        return [dict(lane_tile=t) for t in tiles]
    return [dict(lane_tile=t, time_chunk=c) for t in tiles
            for c in TIME_CHUNKS]


def static_config(kernel: str) -> Dict:
    return dict(table_lib.STATIC_DEFAULTS[kernel])


def _best(candidates, measure) -> Optional[Dict]:
    """Race the candidate configs; None when every one failed."""
    best = None
    for cfg in candidates:
        try:
            us = measure(**cfg)
        except Exception as e:  # noqa: BLE001 - an uninstantiated tile
            print(f"    skip {cfg}: {type(e).__name__}: {e}")
            continue
        print(f"    {cfg} -> {us:.3f} us/frame")
        if best is None or us < best["us_per_frame"]:
            best = dict(cfg, us_per_frame=round(us, 3))
    return best


def _timer(device: torch.device) -> Callable[[Callable, int], float]:
    """ms a call of ``iters`` calls: CUDA events with the calls queued
    behind a spin on a card, the host clock on the CPU."""
    if device.type == "cpu":
        def host(fn, iters):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        return host

    def events(fn, iters):
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # clock cycles: the calls queue up
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    return events


def race(calls: List[Callable], frames: int, rounds: int,
         device: torch.device) -> List:
    """The median µs a frame of each of ``calls`` (a call of each
    candidate), timed in alternating order, forward then backward,
    ``rounds`` times; a candidate whose warm-up call raises keeps its
    exception instead."""
    timer = _timer(device)
    out, iters = list(calls), {}
    for i, fn in enumerate(calls):
        try:
            ms = timer(fn, 1)  # warm-up and an estimate of one call
        except Exception as e:  # noqa: BLE001 - raised again by measure
            out[i] = e
            continue
        iters[i] = max(1, min(50, math.ceil(_TARGET_MS / max(ms, 1e-3))))
    order = list(iters)
    times = {i: [] for i in order}
    for r in range(rounds):
        for i in (order if r % 2 == 0 else order[::-1]):
            times[i].append(timer(calls[i], iters[i]))
    for i in order:
        out[i] = statistics.median(times[i]) * 1e3 / frames
    return out


def _attempt(measure, *args, **cfg):
    """``measure``'s µs, or the exception it raised."""
    try:
        return measure(*args, **cfg)
    except Exception as e:  # noqa: BLE001 - _best reports it
        return e


def _measure_from(results: List, cands: List[Dict]):
    """``measure(**cfg)`` over finished results: its µs, or its error."""
    def measure(**cfg):
        got = results[cands.index(cfg)]
        if isinstance(got, Exception):
            raise got
        return got
    return measure


def _inputs(N: int, T: int, device: torch.device, seed: int = 3):
    rng = np.random.default_rng(seed)
    lkf, imm = get_filter("lkf"), make_imm()

    def bank(model):
        zs = torch.as_tensor(rng.normal(size=(T, N, model.m)) * 0.5,
                             dtype=torch.float32, device=device)
        x0 = torch.as_tensor(np.tile(model.x0, (N, 1)), dtype=torch.float32,
                             device=device)
        P0 = torch.as_tensor(np.tile(model.P0, (N, 1, 1)),
                             dtype=torch.float32, device=device)
        return zs, x0, P0
    return lkf, bank(lkf), imm, bank(imm.models[0])


def tune(Ns=(1024, 8192, 131072), T: int = 300, rounds: int = 5,
         device="cuda", measure=None, report=None) -> Dict:
    """Race every kernel at every bank size; return the entries dict for
    ``write_table`` (this device's key only). ``measure(kernel, N,
    **cfg)`` (µs a frame) replaces the race, as the tests do; ``report``,
    a list, receives a (kernel, N, cfg, µs or the exception) for every
    candidate."""
    device = torch.device(device)
    key = table_lib.device_key(device)
    print(f"tuning the katana_bank tiles for {key}: N {list(Ns)}, T {T}, "
          f"{rounds} rounds")
    entries: Dict[str, Dict[str, List[Dict]]] = {}
    for N in Ns:
        print(f"  N={N}")
        if measure is None:
            lkf, (zs, x0, P0), imm, (zs9, x9, P9) = _inputs(N, T, device)
            runs = {
                "katana_bank": (1, lambda lane_tile: (
                    lambda: ops.katana_bank(lkf, x0, P0, zs[0],
                                            lane_tile=lane_tile))),
                "katana_bank_sequence": (T, lambda lane_tile, time_chunk: (
                    lambda: ops.katana_bank_sequence(
                        lkf, zs, x0, P0, lane_tile=lane_tile,
                        time_chunk=time_chunk))),
                "katana_imm_sequence": (T, lambda lane_tile, time_chunk: (
                    lambda: ops.katana_imm_sequence(
                        imm, zs9, x9, P9, lane_tile=lane_tile,
                        time_chunk=time_chunk)))}
        for kernel in KERNELS:
            print(f"   {kernel}")
            cands = candidates(kernel)
            if measure is None:
                frames, make = runs[kernel]
                results = race([make(**c) for c in cands], frames, rounds,
                               device)
            else:
                results = [_attempt(measure, kernel, N, **c) for c in cands]
            if report is not None:
                report.extend((kernel, N, c, r)
                              for c, r in zip(cands, results))
            best = _best(cands, _measure_from(results, cands))
            if best is None:
                continue
            static = results[cands.index(static_config(kernel))]
            if not isinstance(static, Exception):
                best["static_us_per_frame"] = round(static, 3)
            entries.setdefault(kernel, {}).setdefault(key, []).append(
                dict(N=N, **best))
    return entries


def merge(new: Dict, old: Dict) -> Dict:
    """``old`` entries with ``new``'s rows put in: a (kernel, key) that
    ``new`` holds is replaced whole; other kernels and keys stay."""
    merged = {k: dict(v) for k, v in old.items()}
    for kernel, by_key in new.items():
        merged.setdefault(kernel, {}).update(by_key)
    return merged


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--Ns", default="1024,8192,131072")
    ap.add_argument("--T", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="table path (default: the checked-in tuned.json)")
    ap.add_argument("--dry-run", action="store_true",
                    help="measure and print, write no table")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tune: no CUDA device; the table times the card's "
                         "kernels (pass --device cpu to time the plain "
                         "versions)")
    Ns = tuple(int(n) for n in args.Ns.split(","))
    new = tune(Ns=Ns, T=args.T, rounds=args.rounds, device=device)
    path = (table_lib.TUNED_PATH if args.out is None
            else pathlib.Path(args.out))
    table_lib.clear_cache()  # the file as it is now, not as first read
    merged = merge(new, table_lib._load_table(str(path)))
    print(json.dumps(merged, indent=2, sort_keys=True))
    if args.dry_run:
        return
    table_lib.write_table(merged, path)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
