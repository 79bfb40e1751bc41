"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

Each .cu file is compiled by its own nvcc process for sm_90a, all started
together, and the objects are linked into librs_kernels.so under
robosuite_tpu_torch/_build/<hash of the sources and flags>/, so an edited
source rebuilds and an unchanged one loads at once. The library has a
plain C interface (pointers and the CUDA stream as void*), loaded with
ctypes; no PyTorch header is compiled. nvcc's register/shared-memory
report (-Xptxas -v) is kept beside the library in build.log.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
_SOURCES = ("forward.cu", "contact_solve.cu", "substep.cu", "fk.cu")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v")

P, I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "rs_tables_size": [],
    "rs_forward": [P] * 6 + [I, P] * 3 + [I, P, I, P],
    "rs_forward_smem_bytes": [P],
    "rs_forward_scenarios": [P],
    "rs_smem_limit": [],
    "rs_forward_tab": [P, P],
    "rs_contact_solve": [P] * 11 + [I] * 6 + [ctypes.c_float, P],
    "rs_contact_solve_smem_bytes": [I, I, I],
    "rs_contact_solve_scenarios": [I, I, I],
    "rs_substep": [P] * 14 + [I, P],
    "rs_substep_aux": [P] * 18 + [I, P],
    "rs_substep_smem_bytes": [P],
    "rs_substep_resident": [P, I],
    "rs_fk": [P] * 5 + [I, P],
    "rs_fk_smem_bytes": [P],
}


def _nvcc():
    for cand in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit's nvcc")


def _digest(flags):
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sorted(os.listdir(_CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(_CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build(defines=()) -> str:
    """Compile the kernels if this source hash (and `defines`, extra nvcc
    -D flags of a diagnostic build) has no library yet; returns the
    library's path."""
    flags = (*_FLAGS, *defines)
    out_dir = os.path.join(_BUILD, _digest(flags))
    lib_path = os.path.join(out_dir, "librs_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    os.makedirs(_BUILD, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_BUILD)
    procs = []
    for src in _SOURCES:
        obj = os.path.join(tmp, src.replace(".cu", ".o"))
        cmd = [nvcc, *flags, "-c", os.path.join(_CSRC, src), "-o", obj]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    for src, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src}\n{out}")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
    objs = [os.path.join(tmp, s.replace(".cu", ".o")) for s in _SOURCES]
    link = subprocess.run([nvcc, "-shared", *objs, "-o", os.path.join(tmp, "librs_kernels.so")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    with open(os.path.join(tmp, "build.log"), "w") as f:
        f.write("\n".join(log))
    try:
        os.replace(tmp, out_dir)
    except OSError:  # built concurrently by another process
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


@functools.cache
def library():
    """The loaded kernel library (built at first use)."""
    return load(build())


def load(path):
    """Load a kernel library built by `build`, with its C signatures set
    and its RsTables layout checked against ops/tables.py."""
    from robosuite_tpu_torch.ops.tables import RsTables

    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    lib = ctypes.CDLL(path)
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    if lib.rs_tables_size() != ctypes.sizeof(RsTables):
        raise RuntimeError(
            f"RsTables layout mismatch: C {lib.rs_tables_size()} bytes, Python {ctypes.sizeof(RsTables)}"
        )
    return lib


def check_block(bytes_: int, name: str, what: str):
    """Raise ValueError where a kernel's block needs more shared memory
    than a block may opt in to on this card."""
    limit = library().rs_smem_limit()
    if bytes_ > limit:
        raise ValueError(f"{name}: {what} needs {bytes_} bytes of shared memory a block, over the card's {limit}")


def check(err: int, name: str):
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def raw_stream(device):
    """The current CUDA stream of `device` as an int (without a Stream
    object, where this PyTorch has the call)."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return get(device.index) if get is not None else torch.cuda.current_stream(device).cuda_stream


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def require(t: torch.Tensor, shape, name):
    """A kernel operand: float32, contiguous, on CUDA, of the given shape."""
    if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: need a contiguous float32 CUDA tensor of shape {tuple(shape)}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )
