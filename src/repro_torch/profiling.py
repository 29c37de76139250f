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

``Worker`` keeps one such child for a series of jobs (``python -m
repro_torch.profiling --worker``, a job a line on its standard input, its
result a line back): the serving profiles of ``chip_smoke.py``, five
archs' prefills and decode steps in nine sessions, keep every kernel
event in one child (``scripts/profiler_probe.py --serve``), and one child
saves a process start and its imports a profile.
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
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


class Worker:
    """One child process on the card that runs jobs ("module:function",
    tensors, spec) one after another, started at the first job; ``close``
    ends it. A job that raises in the child raises here with its
    traceback."""

    MARK = "@@repro-job@@ "

    def __init__(self, path=None, timeout: float = 900):
        self.path, self.timeout = path, timeout
        self.proc = self.tmp = None

    def run(self, target: str, tensors=None, **spec):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        if self.proc is None:
            self.tmp = tempfile.TemporaryDirectory()
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")]
                              if p]))
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.profiling", "--worker"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                env=env)
        path = Path(self.tmp.name) / "tensors.pt"
        torch.save(tensors, path)
        self.proc.stdin.write(json.dumps(dict(
            target=target, spec=spec, tensors=str(path),
            path=None if self.path is None else str(self.path))) + "\n")
        self.proc.stdin.flush()
        t_end = time.monotonic() + self.timeout
        while True:
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError(f"job child ended during {target} {spec}")
            if line.startswith(self.MARK):
                break
            if time.monotonic() > t_end:
                self.close()
                raise TimeoutError(f"{target} {spec} past {self.timeout} s")
        out = json.loads(line[len(self.MARK):])
        if "error" in out:
            raise RuntimeError(f"job child {target} {spec} failed:\n"
                               f"{out['error']}")
        return out["result"]

    def close(self) -> None:
        if self.proc is not None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            self.proc = None
        if self.tmp is not None:
            self.tmp.cleanup()
            self.tmp = None


def _worker() -> None:
    for line in sys.stdin:
        job = json.loads(line)
        if job["path"] and job["path"] not in sys.path:
            sys.path.insert(0, job["path"])
        try:
            tensors = torch.load(job["tensors"], map_location="cuda")
            out = dict(result=_resolve(job["target"])(tensors, **job["spec"]))
            del tensors
            torch.cuda.empty_cache()
        except Exception:  # noqa: BLE001 - the parent raises it
            out = dict(error=traceback.format_exc())
        print(Worker.MARK + json.dumps(out), flush=True)


def _child(tmp: str) -> None:
    job = json.loads((Path(tmp) / "job.json").read_text())
    if job["path"]:
        sys.path.insert(0, job["path"])
    fn = _resolve(job["target"])
    tensors = torch.load(Path(tmp) / "tensors.pt", map_location="cuda")
    print(json.dumps(fn(tensors, **job["spec"])))


if __name__ == "__main__":
    if sys.argv[1] == "--worker":
        _worker()
    else:
        _child(sys.argv[1])
