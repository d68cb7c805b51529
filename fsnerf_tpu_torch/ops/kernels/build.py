"""Build and load the hand-written CUDA kernels of csrc/.

The sources compile with nvcc into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes seconds,
not minutes). Each source compiles in its own nvcc process, all started
together, and the objects link into one library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler \
         -fPIC -Xptxas -v -c -o build/<src>.o csrc/<src>      (per source)
    nvcc -shared -o build/libfsnerf_kernels_<hash>.so build/*.o

at first use, into the `build/` directory beside csrc/. The file name
carries a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the library already built. nvcc is taken from
$CUDA_HOME/bin, /usr/local/cuda/bin or PATH.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("render.cu", "mlp.cu", "mlp_train.cu", "siren.cu",
           "volrend.cu")
HEADERS = ("fastmath.cuh", "mlp_common.cuh", "siren_common.cuh",
           "train_common.cuh", "wgmma_common.cuh", "ws_trunk.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    path: Path
    seconds: float      # compile time; 0 when the library was already built
    log: str            # nvcc/ptxas output (registers, shared memory, spills),
                        # kept beside the library as <library>.log


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "fsnerf_tpu_torch build on a machine with the "
                           "CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libfsnerf_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> str:
    """Run the commands side by side; their output, or RuntimeError with
    that of each one that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    failed = [f"{' '.join(c)} -> {p.returncode}\n{log}"
              for c, p, log in zip(cmds, procs, logs) if p.returncode]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "\n".join(logs)


def build() -> Built:
    """Compile csrc/ unless the library for these sources exists."""
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        return Built(out, 0.0,
                     log_path.read_text() if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{s}.o" for s in SOURCES]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                        for s, o in zip(SOURCES, objs)])
        log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        log_path.write_text(log)
        os.replace(tmp, out)        # atomic: a reader never sees half a file
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return Built(out, time.perf_counter() - t0, log)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library with its C signatures declared (built on first
    use)."""
    lib = ctypes.CDLL(str(build().path))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fsnerf_ray_march.argtypes = [vp] * 11 + [i] * 14 + [f, vp]
    lib.fsnerf_ray_march.restype = i
    lib.fsnerf_nerf_mlp.argtypes = [vp] * 6 + [i] * 9 + [vp]
    lib.fsnerf_nerf_mlp.restype = i
    lib.fsnerf_nerf_density.argtypes = [vp] * 5 + [i] * 8 + [vp]
    lib.fsnerf_nerf_density.restype = i
    lib.fsnerf_volrend.argtypes = [vp, i, vp, i] + [vp] * 5 + [i, i, vp]
    lib.fsnerf_volrend.restype = i
    lib.fsnerf_mlp_train_fwd.argtypes = [vp] * 8 + [i] * 10 + [vp]
    lib.fsnerf_mlp_train_fwd.restype = i
    lib.fsnerf_mlp_train_bwd.argtypes = (
        [vp] * 9 + [i] + [vp] * 5 + [i, vp, i, vp, vp] + [i] * 9 + [vp])
    lib.fsnerf_mlp_train_bwd.restype = i
    lib.fsnerf_dw_pass.argtypes = [vp, i, vp, i, vp, i, i, vp, vp, i, vp, i,
                                   i, vp, vp]
    lib.fsnerf_dw_pass.restype = i
    lib.fsnerf_siren_ray_march.argtypes = [vp] * 11 + [i] * 7 + [f, vp]
    lib.fsnerf_siren_ray_march.restype = i
    lib.fsnerf_siren_fwd.argtypes = [vp] * 8 + [i] * 4 + [vp]
    lib.fsnerf_siren_fwd.restype = i
    lib.fsnerf_siren_bwd.argtypes = (
        [vp] * 8 + [i] + [vp] * 3 + [i] + [vp] * 5 + [i, vp, i, vp, vp]
        + [i] * 3 + [vp])
    lib.fsnerf_siren_bwd.restype = i
    lib.fsnerf_siren_stages.argtypes = [i, i, i]
    lib.fsnerf_siren_stages.restype = i
    lib.fsnerf_siren_march_stages.argtypes = [i]
    lib.fsnerf_siren_march_stages.restype = i
    lib.fsnerf_error_string.argtypes = [i]
    lib.fsnerf_error_string.restype = ctypes.c_char_p
    return lib
