"""Process groups on one NVIDIA GPU: NCCL's refusal of two ranks on one
card, and what ``gloo``'s collectives cost between ranks that share it.

    python3 scripts/mesh_probe.py [--out FILE]

(1) Two ranks on ``cuda:0`` in an NCCL group run one ``all_reduce``
(``repro_torch.launch.local_world``, backend "nccl", a 120 s deadline):
NCCL refuses a second rank on a card it already serves; the probe prints
the error's lines. (2) Four ranks on ``cuda:0`` in a ``gloo`` group, the
mesh ('data' 2, 'model' 2): per size, the host ms of ``all_reduce`` over
'model' (gloo takes the CUDA tensor), of the tiled ``all_gather`` and the
``reduce_scatter`` over 'model' (``distributed/collectives.py`` stages
the CUDA tensor through a host buffer) and of ``all_reduce`` over the
whole mesh, each ending in a synchronise, mean of 5 after one warm-up;
bytes a rank sent into the collective over the time.

The last line is one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SIZES_MB = (1, 16, 64)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def nccl_job(rank, tensors):
    import torch
    import torch.distributed as dist

    x = torch.ones(1024, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return float(x[0])


def gloo_job(rank, tensors):
    import torch

    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for mb in SIZES_MB:
        x = torch.randn(mb * 2 ** 19, device="cuda").bfloat16()  # mb MB
        ops = {
            "all_reduce model": lambda: coll.all_reduce(x, mesh, "model"),
            "all_gather model": lambda: coll.all_gather(x, mesh, "model"),
            "reduce_scatter model": lambda: coll.reduce_scatter(
                x, mesh, "model"),
            "all_reduce data+model": lambda: coll.all_reduce(
                x, mesh, ("data", "model")),
        }
        for name, op in ops.items():
            op()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                op()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 5 * 1e3
            out[f"{name} {mb} MB"] = dict(ms=ms, gb_s=mb / 1e3 / (ms / 1e3))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.launch import local_world

    card = smi_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    result = dict(card=card, torch=torch.__version__)
    try:
        local_world.run("mesh_probe:nccl_job", 2, {}, path=ROOT / "scripts",
                        backend="nccl", deadline=120, timeout=60)
        result["nccl_two_ranks_one_card"] = "ran"
        print("NCCL: two ranks on one card ran an all_reduce")
    except RuntimeError as e:
        lines = [ln for ln in str(e).splitlines()
                 if "Duplicate" in ln or "NCCL" in ln or "Error" in ln]
        result["nccl_two_ranks_one_card"] = lines[:12]
        print("NCCL refused two ranks on one card:")
        for ln in lines[:12]:
            print(f"  {ln[:300]}")
    t0 = time.perf_counter()
    ranks = local_world.run("mesh_probe:gloo_job", 4, {},
                            path=ROOT / "scripts", deadline=300)
    result["gloo_world_s"] = time.perf_counter() - t0
    result["gloo"] = ranks
    for name in ranks[0]:
        print(f"gloo {name}: ms a rank "
              f"{[round(r[name]['ms'], 2) for r in ranks]}, GB/s "
              f"{[round(r[name]['gb_s'], 3) for r in ranks]} | {card}")
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
