"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library -> ctypes.

Every ``csrc/*.cu`` file is compiled by an ``nvcc`` of its own, all started
together, and the objects are linked into
``tinydiffusion_torch/_build/<hash>/libtdt_kernels.so``, where ``<hash>``
covers the sources, their ``csrc/*.cuh`` headers and the flags, so an
edited source rebuilds and an unchanged one loads the library that is
there. The sources have a plain C interface and include no PyTorch header,
which keeps the build to seconds (a ``torch.utils.cpp_extension`` build takes
minutes). The build runs on the
first launch of a kernel, never at import: a machine without ``nvcc`` (the
CPU test machines) imports this module and never calls it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
_LIB_NAME = "libtdt_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # the nvcc runs' output (ptxas registers and shared memory per kernel)


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda/bin``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(_CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Build:
    """Compile the kernels unless a library for these sources exists."""
    sources = _sources()
    out_dir = _BUILD_ROOT / _digest(sources)
    lib = out_dir / _LIB_NAME
    log_path = out_dir / "nvcc.log"
    if lib.exists():
        return Build(lib, 0.0, log_path.read_text() if log_path.exists() else "")
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    tmp = out_dir / f"{_LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    # One nvcc a source, all at once: the build takes as long as the slowest.
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs = [proc.communicate(timeout=900)[0] for proc in procs]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [(cmd, proc.returncode) for cmd, proc in zip(cmds, procs) if proc.returncode]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True, timeout=900)
        outputs.append(proc.stdout + proc.stderr)
        if proc.returncode:
            failed.append((link, proc.returncode))
    seconds = time.perf_counter() - t0
    log = "".join(outputs)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return Build(lib, seconds, log)


_P, _I, _U32, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint64

# The ctypes signature of every ``extern "C"`` function in ``csrc/``. Each
# returns an int: a launcher its launch's cudaError_t. Without argtypes ctypes would
# pass every Python int as a 32-bit C int and cut the pointers, so
# ``library()`` declares them all from this one table, and a test checks that
# it names every launcher the sources define.
SIGNATURES: dict[str, tuple] = {
    # qt, kt, vt, out, lse, batch, n, d, c, stream (float32; bfloat16 operands and out)
    "tdt_flash_fwd_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "tdt_flash_fwd_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # qt, kt, vt, dot, lse, delta, dqt, dkt, dvt, dq_part, batch, n, d, c, key_blocks, stream
    # (float32; bfloat16 operands and gradients)
    "tdt_flash_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "tdt_flash_bwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # d, c -> bytes of the kernel's dynamic shared memory (forward; backward pair
    # kernel), float32 and bfloat16
    "tdt_flash_fwd_smem_bytes": (_I, _I),
    "tdt_flash_bwd_smem_bytes": (_I, _I),
    "tdt_flash_fwd_bf16_smem_bytes": (_I, _I),
    "tdt_flash_bwd_bf16_smem_bytes": (_I, _I),
    # x0, t, sqrt_abar, sqrt_1m_abar, xt, z, batch, feat, num_timesteps, seed_ptr
    # (device int64, or null for the next argument), seed, row_offset (the
    # global index of the first row: the Philox counter's row), stream
    "tdt_qsample_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _U64, _U32, _P),
}

_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), argtypes declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = _I
        _lib = lib
    return _lib
