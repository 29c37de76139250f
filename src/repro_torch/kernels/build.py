"""Build and load the port's CUDA kernels: ``nvcc`` -> ``.so`` -> ``ctypes``.

Each source (``kernels/<family>/csrc/<name>.cu``, listed in ``SOURCES``
with its directory) compiles on first use into its own shared library
with a plain C interface, in ``<repo>/build/kernels/``, named by a digest
of the flags, the source and the headers (``*.cuh``) of its own
directory (an edited source or header builds anew). Sources compile in
parallel, one ``nvcc`` process each; a source listed in ``PARTS``
compiles as that many objects at once (``-DKATANA_PART=i``: each holds
its share of the instantiations, part 0 also the C entry), linked into
its library. No PyTorch headers are involved, so a build takes seconds.
The flags keep IEEE rounding: ``--fmad=false`` (no multiply-add
contraction) and no ``--use_fast_math``.

Every exported function returns ``cudaGetLastError()`` after its
launches; ``check`` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "kernels"
_KERNELS = Path(__file__).resolve().parent
# source -> its csrc directory
SOURCES: Dict[str, Path] = {
    **{name: _KERNELS / "katana_bank" / "csrc"
       for name in ("frame.cu", "imm_frame.cu", "greedy.cu", "scan.cu",
                    "imm_scan.cu", "imm_step.cu")},
    **{name: _KERNELS / "flash_attention" / "csrc"
       for name in ("flash_attention.cu", "flash_attention_bwd.cu")},
    "flash_decode.cu": _KERNELS / "flash_decode" / "csrc",
    "ssd_scan.cu": _KERNELS / "ssd_scan" / "csrc",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# sources compiled as several objects in parallel, one a tile of their
# block size (the source's KATANA_PART sections): their instantiations
# tripled with the tiles, and one nvcc took 99-111 s on the H100's host
# (flash_attention_bwd.cu: the C entries and its float32 kernels at DP
# 16-64, the float32 at DP 80-128, the bf16 at DP 16-64, and at DP
# 80-128; whole, it was the build's longest nvcc on the H100's host)
PARTS: Dict[str, int] = {"scan.cu": 3, "imm_step.cu": 3,
                         "flash_attention_bwd.cu": 4}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "frame.cu": {
        "katana_frame_run": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                             _F, _F, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                             _P, _P],
    },
    "imm_frame.cu": {
        "katana_imm_frame_run": [_I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                 _P, _P, _F, _I, _I, _F, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _I, _P, _P],
    },
    "greedy.cu": {
        "greedy_assign_run": [_I, _I, _P, _P, _F, _I, _P, _P, _P, _P, _P,
                              _P],
    },
    "scan.cu": {
        "katana_bank_scan_run": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                 _I, _F, _P, _P, _P, _P, _I, _I, _P],
    },
    "imm_scan.cu": {
        "katana_imm_scan_run": [_I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                _P, _F, _P, _P, _P, _P, _I, _I, _P],
    },
    "imm_step.cu": {
        "katana_imm_step_run": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _F,
                                _F, _P, _P, _P, _I, _I, _P],
        "katana_bank_soa_run": [_I, _I, _I, _I, _P, _P, _P, _P, _I, _F, _P,
                                _P, _I, _I, _P],
    },
    "flash_attention.cu": {
        "flash_attention_run": [_I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                                _F, _I, _I, _P],
        "flash_attention_config": [_I, _I, _P],
    },
    "flash_attention_bwd.cu": {
        "flash_attention_bwd_run": [_I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                                    _P, _P, _P, _P, _P, _P, _F, _I, _I, _P],
        "flash_attention_bwd_config": [_I, _I, _P],
        "flash_attention_bwd_lse_rows": [],
    },
    "flash_decode.cu": {
        "flash_decode_partial_run": [_I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                                     _P, _P, _P, _P, _F, _P],
        "flash_decode_config": [_P],
    },
    "ssd_scan.cu": {
        "ssd_scan_f32_run": [_I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P],
        "ssd_scan_bf16_run": [_I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                              _P, _P, _P, _P, _P, _P, _P],
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# source -> {"path", "seconds", "ptxas": [lines]} for every source built
# or found in this process
BUILD_LOG: Dict[str, dict] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest(source: str) -> str:
    csrc = SOURCES[source]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(str(PARTS.get(source, 1)).encode())
    for p in sorted(csrc.glob("*.cuh")) + [csrc / source]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{_digest(source)}.so"


def _run(cmds):
    """Run the commands at once, each read on a thread of its own (a full
    pipe never stalls one); (exit code, output) of each, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [None] * len(procs)

    def read(i):
        outs[i] = procs[i].communicate()[0]

    threads = [threading.Thread(target=read, args=(i,))
               for i in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _compile(src: str, tmp: Path):
    """(exit code, output) of building ``src`` into ``tmp``: one nvcc, or
    its PARTS objects at once and then their link."""
    path = str(SOURCES[src] / src)
    parts = PARTS.get(src, 1)
    if parts == 1:
        return _run([[nvcc(), *NVCC_FLAGS, "-o", str(tmp), path]])[0]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [tmp.with_suffix(f".{i}.o") for i in range(parts)]
    try:
        runs = _run([[nvcc(), *flags, "-c", f"-DKATANA_PART={i}", "-o",
                      str(o), path] for i, o in enumerate(objs)])
        log = "".join(out for _, out in runs)
        code = max(c for c, _ in runs)
        if code == 0:
            code, out = _run([[nvcc(), "-shared", "-o", str(tmp),
                               *map(str, objs)]])[0]
            log += out
        return code, log
    finally:
        for o in objs:
            o.unlink(missing_ok=True)


def build(sources: Iterable[str] = tuple(SOURCES)) -> Dict[str, dict]:
    """Compile every listed source whose library is missing, all at once
    (one ``nvcc`` each, one a part for ``PARTS``). Raises with the
    compiler's output if any fails. Returns ``BUILD_LOG`` entries for the
    listed sources, each with its own seconds."""
    sources = list(sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {}
    t0 = time.perf_counter()
    for src in sources:
        out = lib_path(src)
        if out.exists():
            BUILD_LOG.setdefault(src, {"path": str(out), "seconds": 0.0,
                                       "ptxas": []})
            continue
        todo[src] = (out.with_suffix(f".{os.getpid()}.tmp"), out)
    # a thread a source, so every compiler runs at once, a full pipe never
    # stalls one, and each source's seconds are its own
    done = {}

    def compile_one(src, tmp):
        done[src] = _compile(src, tmp) + (time.perf_counter() - t0,)

    threads = [threading.Thread(target=compile_one, args=(src, tmp))
               for src, (tmp, _) in todo.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = []
    for src, (tmp, out) in todo.items():
        code, log, seconds = done[src]
        if code != 0:
            failed.append(f"--- {src} (exit {code})\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[src] = {
            "path": str(out), "seconds": seconds,
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling entry" in ln]}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {src: BUILD_LOG[src] for src in sources}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(lib_path(source)))
            for name, argtypes in SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.katana_error_string.argtypes = [ctypes.c_int]
            lib.katana_error_string.restype = ctypes.c_char_p
            _LIBS[source] = lib
        return lib


def on_cuda(t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (run the plain version); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def aligned16(t):
    """``t`` contiguous at a 16-byte aligned address (the kernels' vector
    loads and TMA need it): a copy only where a view starts off it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_of(device) -> int:
    """The handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = lib.katana_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
