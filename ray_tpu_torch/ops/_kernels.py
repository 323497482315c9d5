"""Build, load and launch the hand-written CUDA kernels.

Each kernel has a source of its own under ``ray_tpu_torch/csrc/``
(``flash_fwd.cu``, ``flash_dkv.cu``, ``flash_dq.cu``, sharing the headers
``flash_common.cuh`` and ``sm90.cuh``).  Each is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds) and loaded with ``ctypes``.
All three launchers encode TMA tensor maps on the host through
``cuTensorMapEncodeTiled``, which they reach with
``cudaGetDriverEntryPoint``: no ``-lcuda`` at link time.  The build
happens at first use, into ``ray_tpu_torch/_build/<hash>/`` keyed by a
hash of every file under ``csrc/`` and the flags, so a checkout builds
everything it runs from its own files.  All sources compile in parallel,
one ``nvcc`` each.

Each wrapper checks what its kernel takes and raises on anything else,
allocates its outputs with ``torch.empty``, launches on the current
stream, raises if the launcher returned a CUDA error, and then counts the
launch in ``launches``.  Wrappers only take CUDA tensors: the callers in
``flash_attention.py`` send CPU tensors to the plain versions instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
# One source per kernel; each exports the launcher named after its stem
# and ``<stem>_smem()``, the dynamic shared memory of one block.
SOURCES = ("flash_fwd.cu", "flash_dkv.cu", "flash_dq.cu")
_SUFFIXES = (".cu", ".cuh", ".h")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

TILE = 64        # rows of a kernel tile: T must be a multiple of it
HEAD_DIM = 64    # the kernels are compiled for d_head = 64

# Launch counts, one plain integer per kernel wrapper.
launches = {"flash_fwd": 0, "flash_dkv": 0, "flash_dq": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def source_hash() -> str:
    """Hash of the flags and of every source and header under ``CSRC``,
    so an edit to a header rebuilds every kernel."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.suffix in _SUFFIXES):
        h.update(str(path.relative_to(CSRC)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{home}/bin); the CUDA kernels cannot be built")
    return path


def build() -> dict:
    """Compile every source not yet built for this hash, in parallel.
    Returns {stem: path of its .so}.  Each build's compiler output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside
    the library as ``<stem>.log``."""
    out = build_dir()
    libs = {Path(s).stem: out / (Path(s).stem + ".so") for s in SOURCES}
    todo = [(s, libs[Path(s).stem]) for s in SOURCES
            if not libs[Path(s).stem].exists()]
    if not todo:
        return libs
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs.append((src, lib, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        log = proc.communicate()[0]
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, lib)        # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


_lock = threading.Lock()
_fns = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_fwd": [_P, _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong),
                  _I, _I, _I, _I, ctypes.c_float, _P],
    "flash_dkv": [_P, _P, _P, _P, _P, _P, _P, _P,
                  ctypes.POINTER(ctypes.c_longlong),
                  _I, _I, _I, _I, ctypes.c_float, _P],
    "flash_dq": [_P, _P, _P, _P, _P, _P, _P,
                 ctypes.POINTER(ctypes.c_longlong),
                 _I, _I, _I, _I, ctypes.c_float, _P],
}


def library() -> dict:
    """{launcher name: its ctypes function}, from one library per source."""
    global _fns
    with _lock:
        if _fns is None:
            fns = {}
            for stem, path in build().items():
                lib = ctypes.CDLL(str(path))
                fn = getattr(lib, stem)
                fn.argtypes = _SIGNATURES[stem]
                fn.restype = ctypes.c_int
                fns[stem] = fn
                smem = getattr(lib, stem + "_smem")
                smem.argtypes = []
                smem.restype = ctypes.c_int
                fns[stem + "_smem"] = smem
            _fns = fns
    return _fns


def dynamic_smem(name: str) -> int:
    """Dynamic shared memory of one block of kernel ``name``, in bytes."""
    return library()[name + "_smem"]()


# ----------------------------------------------------------- checks
def _check_bthd(name: str, *tensors: torch.Tensor) -> None:
    ref = tensors[0]
    for x in tensors:
        if x.device.type != "cuda" or x.device != ref.device:
            raise ValueError(f"{name}: every tensor must lie on one CUDA "
                             f"device, got {x.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bfloat16, "
                             f"got {x.dtype}")
        if x.dim() != 4 or x.shape != ref.shape:
            raise ValueError(f"{name}: expected equal [B, T, H, D] shapes, "
                             f"got {tuple(x.shape)} and {tuple(ref.shape)}")
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name}: needs a unit d stride, 16-byte "
                             f"aligned rows; got strides {x.stride()}")
    _b, t, _h, d = ref.shape
    if d != HEAD_DIM:
        raise ValueError(f"{name}: the kernel is built for head width "
                         f"{HEAD_DIM}, got {d}")
    if t % TILE:
        raise ValueError(f"{name}: T={t} must be a multiple of the "
                         f"kernel tile {TILE}")


def _check_rows(name: str, ref: torch.Tensor, *rows: torch.Tensor) -> None:
    b, t, h, _d = ref.shape
    for x in rows:
        if x.device != ref.device or x.dtype != torch.float32 \
                or x.shape != (b, h, t) or not x.is_contiguous() \
                or x.data_ptr() % 16:
            raise ValueError(f"{name}: lse/delta must be contiguous, "
                             f"16-byte aligned float32 [B, H, T] = "
                             f"{(b, h, t)} on "
                             f"{ref.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def _strides(*tensors: torch.Tensor):
    flat = [s for x in tensors for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA "
                           f"error {rc}")
    launches[name] += 1


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------- wrappers
def flash_fwd(q, k, v, *, scale: float, causal: bool):
    """q, k, v: bf16 [B, T, H, 64] -> (out bf16 [B, T, H, 64],
    lse fp32 [B, H, T])."""
    _check_bthd("flash_fwd", q, k, v)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        fn = library()["flash_fwd"]
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), _strides(q, k, v, out), b, h, t, int(causal),
                scale, _stream(q))
    _launched("flash_fwd", rc)
    return out, lse


def flash_dkv(q, k, v, do, lse, delta, *, scale: float, causal: bool):
    """-> (dk, dv), bf16 [B, T, H, 64]."""
    _check_bthd("flash_dkv", q, k, v, do)
    _check_rows("flash_dkv", q, lse, delta)
    b, t, h, _d = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        fn = library()["flash_dkv"]
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                _strides(q, k, v, do, dk, dv), b, h, t, int(causal), scale,
                _stream(q))
    _launched("flash_dkv", rc)
    return dk, dv


def flash_dq(q, k, v, do, lse, delta, *, scale: float, causal: bool):
    """-> dq, bf16 [B, T, H, 64]."""
    _check_bthd("flash_dq", q, k, v, do)
    _check_rows("flash_dq", q, lse, delta)
    b, t, h, _d = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        fn = library()["flash_dq"]
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                _strides(q, k, v, do, dq), b, h, t, int(causal), scale,
                _stream(q))
    _launched("flash_dq", rc)
    return dq
