"""One torch.profiler job in a fresh process.

Later torch.profiler sessions of one long process lose some or all of
their kernel events on the H100 (PERF.md §7), and ``acc_events=True``
does not keep them; the first session of a fresh process records every
launch. ``fresh(target, tensors, **spec)`` therefore runs each profile in
a child process of its own:

    python -m repro_torch.profiling DIR

``tensors`` reach the child through ``torch.save`` (loaded onto the
card), ``spec`` as JSON. The child imports ``target``
("module:function", the module found on ``path`` or in the port),
calls ``function(tensors, **spec)`` and prints its JSON result as its
last line, which ``fresh`` returns. ``call_events`` is a ready job: the
kernel events of calls of one function.
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parents[1]
ACTIVITIES = (torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA)


def kernel_events(prof):
    """({name: device ms summed}, {name: events}) of the device events
    of a finished ``torch.profiler.profile`` session."""
    ms, count = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms[e.name] = ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            count[e.name] = count.get(e.name, 0) + 1
    return ms, count


def _resolve(target: str):
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)


def call_events(tensors, fn: str, iters: int = 1) -> dict:
    """Job: {kernel name: events} of ``iters`` calls of ``fn``
    ("module:function") on ``tensors`` = (args, kwargs), profiled after
    one call outside the session."""
    f = _resolve(fn)
    args, kwargs = tensors
    f(*args, **kwargs)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=list(ACTIVITIES)) as prof:
        for _ in range(iters):
            f(*args, **kwargs)
        torch.cuda.synchronize()
    return kernel_events(prof)[1]


def fresh(target: str, tensors=None, path=None, timeout: float = 900,
          **spec):
    """Run the job ``target(tensors, **spec)`` in a fresh process on the
    card and return its result; raise with the child's output if it
    fails."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(tensors, Path(tmp) / "tensors.pt")
        (Path(tmp) / "job.json").write_text(json.dumps(dict(
            target=target, path=None if path is None else str(path),
            spec=spec)))
        out = subprocess.run([sys.executable, "-m", "repro_torch.profiling",
                              tmp], capture_output=True, text=True,
                             timeout=timeout, env=env)
    if out.returncode != 0:
        raise RuntimeError(f"profile child {target} {spec} failed:\n"
                           f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _child(tmp: str) -> None:
    job = json.loads((Path(tmp) / "job.json").read_text())
    if job["path"]:
        sys.path.insert(0, job["path"])
    fn = _resolve(job["target"])
    tensors = torch.load(Path(tmp) / "tensors.pt", map_location="cuda")
    print(json.dumps(fn(tensors, **job["spec"])))


if __name__ == "__main__":
    _child(sys.argv[1])
