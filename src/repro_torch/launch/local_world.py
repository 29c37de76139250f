"""A function run by every rank of a world of processes on one host, with
a deadline.

    results = run("module:function", n, spec, tensors=..., path=...)
    world = start(...); ...; results = world.wait()   # work meanwhile

Each rank is a process of its own (``python -m
repro_torch.launch.local_world DIR RANK``) that initialises a process
group over a file store in DIR (the backend is the caller's choice, with
``timeout`` on every collective), selects the card (every rank on
``cuda:0`` when the host has one, rank r on card r otherwise), calls
``function(rank, tensors, **spec)`` and saves what it returns. ``run``
(or ``wait`` after ``start``) waits for all ranks; past ``deadline``
seconds, or (with ``stall``) after ``stall`` seconds in which the ranks
used no CPU between them (a deadlock: a crowded host still makes
progress), it kills every one and raises, and it raises with the failed
ranks' output if any fails. It returns the ranks' results in rank order
(``torch.load`` of files the children wrote). ``watch`` is that wait for
any processes.

``tensors`` reach every rank through ``torch.save`` (loaded onto the
CPU), ``spec`` as JSON. ``path`` is put first on the children's
``sys.path`` (where ``module`` lives, if not in the port).
"""
from __future__ import annotations

import importlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

SRC = Path(__file__).resolve().parents[2]


def cpu_seconds(pid: int) -> float:
    """User + system CPU seconds of a live process, all its threads (Linux
    ``/proc``); 0.0 once it is gone."""
    try:
        fields = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1]
        fields = fields.split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


# CPU seconds the watched processes must use between them within a
# ``stall`` window to count as making progress
PROGRESS_CPU_S = 1.0


def watch(procs, t_end: float, stall: float = None):
    """Wait until every process of ``procs`` (``subprocess.Popen``) has
    ended. Stops at the monotonic time ``t_end``, or, with ``stall``, once
    the processes used under PROGRESS_CPU_S of CPU between them in the
    last ``stall`` seconds. Returns (the processes still running, why:
    "deadline", "stall" or None) for the caller to kill."""
    used = {p.pid: 0.0 for p in procs}
    mark_cpu, mark_t = 0.0, time.monotonic()
    while any(p.poll() is None for p in procs):
        now = time.monotonic()
        if now >= t_end:
            return [p for p in procs if p.poll() is None], "deadline"
        if stall is not None:
            for p in procs:
                if p.poll() is None:
                    used[p.pid] = max(used[p.pid], cpu_seconds(p.pid))
            total = sum(used.values())
            if total - mark_cpu >= PROGRESS_CPU_S:
                mark_cpu, mark_t = total, now
            elif now - mark_t >= stall:
                return [p for p in procs if p.poll() is None], "stall"
        time.sleep(0.1)
    return [], None


class World:
    """The ranks of one ``start``: ``wait`` for their results."""

    def __init__(self, target: str, n: int, spec: dict, tensors, path,
                 backend: str, deadline: float, timeout: float,
                 stall: float = None):
        self.target, self.n = target, n
        self.tmp = tempfile.TemporaryDirectory()
        d = Path(self.tmp.name)
        torch.save(tensors, d / "tensors.pt")
        (d / "job.json").write_text(json.dumps(dict(
            target=target, path=None if path is None else str(path),
            spec=spec, n=n, backend=backend, timeout=timeout)))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        self.logs = [open(d / f"rank{r}.log", "w") for r in range(n)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.local_world",
             self.tmp.name, str(r)], env=env, stdout=self.logs[r],
            stderr=subprocess.STDOUT, start_new_session=True)
            for r in range(n)]
        self.deadline, self.stall = deadline, stall
        self.t_end = time.monotonic() + deadline

    def wait(self):
        """The ranks' results in rank order; raises if a rank failed, or
        kills every rank and raises past the deadline or a stall."""
        d = Path(self.tmp.name)
        why = None
        try:
            why = watch(self.procs, self.t_end, self.stall)[1]
        finally:
            hung = [p for p in self.procs if p.poll() is None]
            for p in hung:
                os.killpg(p.pid, signal.SIGKILL)
            for p in self.procs:
                p.wait()
            for f in self.logs:
                f.close()
        try:
            failed = [r for r, p in enumerate(self.procs)
                      if p.returncode != 0]
            if hung or failed:
                tails = "\n".join(
                    f"--- rank {r} ---\n"
                    f"{(d / f'rank{r}.log').read_text()[-4000:]}"
                    for r in (failed or range(self.n)))
                what = (f"ranks {failed} failed" if not hung
                        else f"no CPU used for {self.stall:.0f} s "
                        f"({len(hung)} killed)" if why == "stall"
                        else f"past its {self.deadline:.0f} s deadline "
                        f"({len(hung)} killed)")
                raise RuntimeError(f"{self.target} on {self.n} ranks: "
                                   f"{what}\n{tails}")
            return [torch.load(d / f"result{r}.pt", weights_only=False)
                    for r in range(self.n)]
        finally:
            self.tmp.cleanup()


def start(target: str, n: int, spec: dict, tensors=None, path=None,
          backend: str = "gloo", deadline: float = 600.0,
          timeout: float = 300.0, stall: float = None) -> World:
    """Start ``target(rank, tensors, **spec)`` on each of ``n`` ranks; the
    caller may work meanwhile, then ``wait``."""
    return World(target, n, spec, tensors, path, backend, deadline, timeout,
                 stall)


def run(target: str, n: int, spec: dict, tensors=None, path=None,
        backend: str = "gloo", deadline: float = 600.0,
        timeout: float = 300.0, stall: float = None):
    """``target(rank, tensors, **spec)`` on each of ``n`` ranks; returns
    their results in rank order."""
    return start(target, n, spec, tensors, path, backend, deadline,
                 timeout, stall).wait()


def _child(tmp: str, rank: int) -> None:
    d = Path(tmp)
    job = json.loads((d / "job.json").read_text())
    if job["path"]:
        sys.path.insert(0, job["path"])
    # the host's cores shared out: n ranks each spinning on all of them
    # slow every one
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // job["n"]))
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(job["backend"],
                            init_method=f"file://{d / 'store'}", rank=rank,
                            world_size=job["n"],
                            timeout=timedelta(seconds=job["timeout"]))
    try:
        module, name = job["target"].split(":")
        fn = getattr(importlib.import_module(module), name)
        tensors = torch.load(d / "tensors.pt", weights_only=False)
        result = fn(rank, tensors, **job["spec"])
        torch.save(result, d / f"result{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
