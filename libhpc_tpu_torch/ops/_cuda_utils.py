"""Shared helpers for the port's hand-written CUDA kernels.

Port of ``libhpc_tpu/ops/_pallas_utils.py`` (``cdiv``, ``round_up``), plus
what a Hopper kernel needs around it:

- the kernel builder: every ``csrc/*.cu`` is compiled by its own nvcc for
  sm_90a, all at once, and the objects are linked into one shared library
  with a plain C interface, at the first launch, into
  ``libhpc_tpu_torch/_build/`` under a name keyed by a hash of the sources,
  the headers they share (``csrc/*.cuh``) and the flags; it is loaded with
  ctypes. Importing this module builds nothing and touches no CUDA state.
- ``ptxas_usage``: each kernel's registers and spills, from ``nvcc -Xptxas
  -v`` (the build keeps each source's report beside the library).
- ``kernel_fn``: a C entry point of that library with its argtypes set
  (every pointer and the stream as c_void_p, sizes as c_int).
- ``check_launch``: raises when an entry point returns a CUDA error.
- ``check_tensor``: the device/dtype/shape/contiguity checker every wrapper
  runs before it hands pointers to a kernel.
- ``as_tensor``: how an entry point takes numpy input (to ``device``).

Dispatch rule of every wrapper: tensors on the CPU take the plain PyTorch
version; CUDA tensors launch the kernel or raise. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
PTXAS_FLAGS = ("-Xptxas", "-v")   # registers and spills, on stderr
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the CUDA kernels are built from csrc/*.cu at their "
                       "first launch)")


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> Path:
    """Where the kernel library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + PTXAS_FLAGS
                                + LINK_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhpc_kernels_{h.hexdigest()[:16]}.so"


def _ptxas_report(so: Path, source: str) -> Path:
    """Where the build of library `so` keeps ptxas's report of `source`."""
    return so.with_name(f"{so.stem}.{Path(source).stem}.ptxas.txt")


def build_library() -> Path:
    """Compile csrc/*.cu into the keyed shared library unless it exists:
    one nvcc per source, all started together, then one link; each
    source's ptxas report is kept beside the library. The build writes
    temporary files and renames the reports, then the library, into place,
    so concurrent builders never load a half-written library."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    tmp = BUILD_DIR / f"{tag}.tmp"
    jobs = []
    try:
        for src in _sources():
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *PTXAS_FLAGS, "-c", "-o", str(obj),
                 str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors, reports = [], []
        for src, _, proc in jobs:
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                errors.append(f"{src.name} ({proc.returncode}):\n{err}")
            reports.append((_ptxas_report(so, src.name), err))
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        res = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
            capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        for path, err in reports:
            part = path.with_name(f"{tag}.{path.name}")
            part.write_text(err)
            os.replace(part, path)
        os.replace(tmp, so)
    finally:
        for _, obj, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            obj.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return so


def count_sass(opcode: str) -> int:
    """Lines of the built library's SASS (``cuobjdump -sass``, beside
    nvcc) that hold `opcode`, e.g. "HGMMA" for wgmma."""
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(build_library())],
                          check=True, capture_output=True, text=True,
                          timeout=600).stdout
    return sum(opcode in line for line in sass.splitlines())


def ptxas_usage(*sources: str) -> dict:
    """Registers and spilled bytes of every kernel of the named csrc/
    sources, as ``nvcc -Xptxas -v`` reports them: from the reports the
    build of the current library kept, or, where one is missing, from a
    compile of its own (one nvcc per source, all started together, objects
    discarded): mangled kernel name ->
    {"registers", "spill_stores", "spill_loads"}."""
    so = library_path()
    kept = [_ptxas_report(so, name) for name in sources]
    if all(path.exists() for path in kept):
        reports = [path.read_text() for path in kept]
    else:
        reports = _compile_reports(sources)
    usage, fn = {}, None
    for err in reports:
        for line in err.splitlines():
            m = re.search(r"(?:entry function '|Function properties for )"
                          r"([^' ]+)", line)
            if m:
                fn = m.group(1)
                usage.setdefault(fn, {})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and fn:
                usage[fn].update(spill_stores=int(m.group(1)),
                                 spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                usage[fn]["registers"] = int(m.group(1))
    return usage


def _compile_reports(sources) -> list[str]:
    """ptxas's report of each named csrc/ source from an nvcc of its own."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = find_nvcc()
    jobs = []
    for name in sources:
        obj = BUILD_DIR / f"ptxas.{os.getpid()}.{Path(name).stem}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *PTXAS_FLAGS, "-c", "-o", str(obj),
             str(CSRC_DIR / name)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    reports = []
    for obj, proc in jobs:
        _, err = proc.communicate(timeout=600)
        obj.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed:\n{err}")
        reports.append(err)
    return reports


_LIB: ctypes.CDLL | None = None
_FNS: dict = {}


def kernel_lib() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build_library()))
    return _LIB


def kernel_fn(name: str, n_ptrs: int, n_ints: int):
    """C entry point ``int name(void* ptrs..., int ints..., void* stream)``
    with its argtypes and restype set."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(kernel_lib(), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                       + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def current_stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_launch(rc: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def check_tensor(t, name: str, device: torch.device, dtypes, shape) -> None:
    """Raise unless t is a contiguous tensor on `device` whose dtype is in
    `dtypes` and whose shape equals `shape`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of "
                        f"{tuple(dtypes)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def as_tensor(x, device) -> torch.Tensor:
    """A numpy array moved to ``device`` (an entry point's default is
    "cuda"); a torch tensor as it is, on its own device. Anything else (a
    list, a tuple, a scalar) becomes an array as ``jnp.asarray`` makes it
    without x64: Python floats float32, Python ints int32."""
    if isinstance(x, torch.Tensor):
        return x
    if not isinstance(x, np.ndarray):
        x = np.asarray(x)
        x = x.astype({np.dtype(np.float64): np.float32,
                      np.dtype(np.int64): np.int32}.get(x.dtype, x.dtype))
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def kernel_device(*tensors: torch.Tensor) -> torch.device:
    """The one device all of a wrapper's tensors lie on: CPU selects the
    plain version, CUDA the kernel; a mix or another device raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev
