"""Build the hand-written Hopper kernels at first use and load them.

Each `csrc/<name>.cu` compiles with `nvcc` into its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), under
`build/kernels/` at the repository root (`REPRO_TORCH_BUILD_DIR` moves it).
All missing libraries build in parallel, one `nvcc` process per source,
and a library's file name carries a hash of its source, the shared
headers (`csrc/*.cuh`) and the flags, so an edited kernel or header
rebuilds and an unchanged one is reused.  The libraries load with
`ctypes`; `kernels/ops.py` declares each entry point's argument types.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NAMES = ("qmatmul", "quantize", "ubn", "page_gather", "paged_attention",
         "backward", "flash_attention", "selective_scan",
         "selective_scan_bwd")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    """The library path of `name`: its hash covers the source, every shared
    header under csrc/ (which any source may include) and the flags."""
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=NAMES) -> dict[str, Path]:
    """Compile every library in `names` that is not built yet, all at once.

    Returns {name: library path}.  Raises RuntimeError with the compiler's
    output if any build fails.  The `-Xptxas -v` report (registers, shared
    memory, spills) of each build is kept beside it as `<lib>.log`."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, tgt in targets.items():
        if tgt.exists():
            continue
        tmp = tgt.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, tgt)
    errors = []
    for n, (proc, tmp, tgt) in procs.items():
        log, _ = proc.communicate()
        tgt.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"--- nvcc {n}.cu (rc={proc.returncode})\n{log}")
            continue
        os.replace(tmp, tgt)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `name`, building every missing one first."""
    if name not in _LIBS:
        paths = build()
        for n, p in paths.items():
            if n not in _LIBS:
                _LIBS[n] = ctypes.CDLL(str(p))
    return _LIBS[name]
