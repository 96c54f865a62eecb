"""Build the package's CUDA kernels at first use and load them with ctypes.

Every ``grove_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` on its own
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds). Libraries go into ``grove_tpu_torch/_build/<hash>/``,
where the hash covers the source text and the compiler flags, so an edited
source builds anew and an unchanged one is reused. All sources are compiled
in parallel, one ``nvcc`` process each. A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class Build:
    """Libraries by source stem; when this call compiled anything, the
    wall seconds and each compiler's output (ptxas registers, spills)."""
    paths: dict[str, Path]
    seconds: float = 0.0
    logs: dict[str, str] = dataclasses.field(default_factory=dict)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):  # sources and any headers
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Build:
    """Compile every source that has no library yet."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, out_dir / f"lib{src.stem}.so")
               for src in _sources()}
    build = Build(paths={stem: lib for stem, (_, lib) in targets.items()})
    todo = {stem: t for stem, t in targets.items() if not t[1].exists()}
    if not todo:
        return build
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for stem, (src, lib) in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[stem] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    failed = []
    for stem, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        build.logs[stem] = out
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    build.seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return build


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if needed)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            paths = build_all().paths
            if stem not in paths:
                raise RuntimeError(f"no source csrc/{stem}.cu")
            lib = ctypes.CDLL(str(paths[stem]))
            _libs[stem] = lib
        return lib
