"""Build and load the port's native libraries: compiler -> shared library -> ctypes.

Two libraries go through the one code path here:

- ``KERNELS``, the CUDA kernels: every ``ops/csrc/*.cu`` file compiled by an
  ``nvcc`` of its own (``sm_90a``), all started together, and the objects
  linked into ``tinydiffusion_torch/_build/<hash>/libtdt_kernels.so``. The
  sources have a plain C interface and include no PyTorch header, which
  keeps the build to seconds (a ``torch.utils.cpp_extension`` build takes
  minutes).
- ``DECODERS``, the LAION loader's image decoders on the host: every
  ``data/csrc/*.c`` file (C11, libc only) compiled by the host C compiler
  (``$CC``, else ``cc``, else ``gcc``) into ``_build/<hash>/libtdt_decode.so``.
  Every machine builds it, the CPU test machines included.

``<hash>`` covers the library's name, the compiler's flags, its sources and
their headers, so an edited source rebuilds and an unchanged one loads the
library that is there. A build writes under names of its own process and
thread, then renames the library into place (atomic), so processes that
build at once (pytest's workers) never load half a file. A library is built
at its first use, never at import: a machine without ``nvcc`` (the CPU test
machines) imports this module and never builds the kernels. A missing
compiler or a failed build raises ``RuntimeError`` with the compiler's output.
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
from typing import Callable

_CSRC = Path(__file__).resolve().parent / "csrc"
_DATA_CSRC = Path(__file__).resolve().parents[1] / "data" / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)
# -fwrapv: signed integers wrap as numpy's int64 does in the plain versions.
# -ffp-contract=off: no product and sum fused into one rounding (an FMA), so
# that the JPEG 2000 9/7 wavelet and ICT round as OpenJPEG's float32 code.
CC_FLAGS = ("-std=c11", "-O2", "-fPIC", "-fwrapv", "-ffp-contract=off", "-Wall")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # the compilers' output (for the kernels: ptxas registers and shared memory)
    compiler: str = ""  # the compiler's path ("" when the library was already built)


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


def find_cc() -> str:
    """The host C compiler: ``$CC``, else ``cc``, else ``gcc`` on ``PATH``."""
    for name in (os.environ.get("CC"), "cc", "gcc"):
        path = name and shutil.which(name)
        if path:
            return path
    raise RuntimeError(
        "no C compiler found ($CC, cc, gcc); the image decoders cannot be built"
    )


@dataclasses.dataclass(frozen=True)
class Library:
    """One shared library: its sources, headers, compiler and flags."""

    name: str
    csrc: Path
    source_glob: str
    header_glob: str
    flags: tuple
    find_compiler: Callable[[], str]
    log_name: str

    def sources(self) -> list[Path]:
        return sorted(self.csrc.glob(self.source_glob))

    def digest(self) -> str:
        """Hash of the name, the flags, the sources and their headers."""
        h = hashlib.sha256(" ".join((self.name, *self.flags)).encode())
        for src in [*self.sources(), *sorted(self.csrc.glob(self.header_glob))]:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return h.hexdigest()[:16]


KERNELS = Library("libtdt_kernels.so", _CSRC, "*.cu", "*.cuh", NVCC_FLAGS, find_nvcc, "nvcc.log")
DECODERS = Library("libtdt_decode.so", _DATA_CSRC, "*.c", "*.h", CC_FLAGS, find_cc, "cc.log")


def build(lib: Library = KERNELS) -> Build:
    """Compile ``lib`` unless a library for these sources exists."""
    sources = lib.sources()
    out_dir = _BUILD_ROOT / lib.digest()
    path = out_dir / lib.name
    log_path = out_dir / lib.log_name
    if path.exists():
        return Build(path, 0.0, log_path.read_text() if log_path.exists() else "")
    compiler = lib.find_compiler()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}.tmp"
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    tmp = out_dir / f"{lib.name}.{tag}"
    t0 = time.perf_counter()
    # One compiler a source, all at once: the build takes as long as the slowest.
    cmds = [[compiler, *lib.flags, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs = [proc.communicate(timeout=900)[0] for proc in procs]
    link = [compiler, *lib.flags, "-shared", "-o", str(tmp), *map(str, objs)]
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
        raise RuntimeError(f"{os.path.basename(compiler)} failed ({rc}): {' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return Build(path, seconds, log, compiler)


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
    # qt, kt, vt, dot, lse, delta, dqt, dkt, dvt, dq_count, batch, n, d, c, query_tiles,
    # stream (float32; the counters int32)
    "tdt_flash_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # the same with dq_run (float32 run sums) before dq_count (bfloat16 operands and
    # gradients)
    "tdt_flash_bwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
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

# The ctypes signature of every ``tdt_*`` function in ``data/csrc/``. Each
# returns an int: 0, or a negative code the Python side turns into
# ``ValueError``. Buffers are numpy arrays' pointers; every one comes with
# its length, which the C side never reads or writes past.
_I64 = ctypes.c_int64
DECODE_SIGNATURES: dict[str, tuple] = {
    # data, seg_start (n_segs + 1 byte offsets), n_segs, luts (n_luts x 65536
    # uint16: length << 8 | symbol), n_luts, geom (int64, data/jpeg.py::_scan_geometry),
    # n_geom, coef (int64, zigzag order), coef_len
    "tdt_jpeg_scan": (_P, _P, _I64, _P, _I64, _P, _I64, _P, _I64),
    # data, seg_start, n_segs, cond (int64: L, U of the 16 DC tables, Kx of the 16
    # AC tables), last_open, geom (data/jpeg.py::_scan_geometry), n_geom, coef,
    # coef_len, fetched (int64, n_segs: the bytes each segment's decoder asked for)
    "tdt_jpeg_arith_scan": (_P, _P, _I64, _P, _I64, _P, _I64, _P, _I64, _P),
    # data, seg_start, n_segs, luts, n_luts, geom (int64, data/jpeg.py::_lossless_geometry),
    # n_geom, planes (int64 samples), planes_len
    "tdt_jpeg_lossless_scan": (_P, _P, _I64, _P, _I64, _P, _I64, _P, _I64),
    # coef, coef_len, qtables (64 int64 a component), geom (data/jpeg.py::_pixels),
    # n_geom, rgb (uint8), rgb_len
    "tdt_jpeg_pixels": (_P, _I64, _P, _P, _I64, _P, _I64),
    # data, n, min_size, out (uint8 indices), count, written (int64, set)
    "tdt_gif_lzw": (_P, _I64, _I64, _P, _I64, _P),
    # data, n, out (uint8), count, written (int64, set)
    "tdt_tiff_lzw": (_P, _I64, _P, _I64, _P),
    "tdt_tiff_packbits": (_P, _I64, _P, _I64, _P),
    # data, n, rgb (uint8, height x width x 3), width, height (from the header)
    "tdt_vp8_decode": (_P, _I64, _P, _I64, _I64),
    "tdt_vp8l_decode": (_P, _I64, _P, _I64, _I64),
    # data (a tile's packets), n, params (int64, data/jpeg2000.py::_tile_params),
    # n_params, out (int32, every tile component in turn), out_len
    "tdt_j2k_tile": (_P, _I64, _P, _I64, _P, _I64),
    # data (a TGA's run-length packets), n, depth (bytes a pixel), out (uint8, rows x
    # row_bytes), row_bytes, rows
    "tdt_tga_rle": (_P, _I64, _I64, _P, _I64, _I64),
    # data (a QOI's ops, from byte 14), n, rgb (uint8, pixels x 3), pixels
    "tdt_qoi_decode": (_P, _I64, _P, _I64),
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def library(lib: Library = KERNELS) -> ctypes.CDLL:
    """The loaded library (built on first call), argtypes declared."""
    if lib.name not in _libs:
        with _lock:  # threads of one process build and load it once
            if lib.name not in _libs:
                handle = ctypes.CDLL(str(build(lib).path))
                table = SIGNATURES if lib is KERNELS else DECODE_SIGNATURES
                for name, argtypes in table.items():
                    fn = getattr(handle, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = _I
                _libs[lib.name] = handle
    return _libs[lib.name]
