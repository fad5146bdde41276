"""Build and load the port's CUDA libraries.

Each library is one ``csrc/<stem>.cu`` (plus the headers it includes)
compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded with ``ctypes``. The build happens at the first launch,
into ``build/repro_torch/`` at the root of the checkout; the file name
carries a hash of the sources and the flags, so a changed source builds
anew and an unchanged one loads what is there. Importing this module needs
neither ``nvcc`` nor a card. No library is built with nvcc's fast-math
switch: the kernels keep IEEE division, square roots and denormals.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Callable, Sequence

import torch

__all__ = ["build", "build_dir", "check", "device_launches", "forbid_grad",
           "takes", "parse_resource_usage", "resource_usage", "BUILD_INFO",
           "ARCH_FLAGS", "DTYPES"]

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# storage types of the model kernels, by their C code (csrc/dtype.cuh)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def takes(dtype: torch.dtype, device: torch.device) -> bool:
    """Whether a model kernel's wrapper takes ``dtype`` on ``device``: the
    kernels' storage types, and on the CPU float64 besides (the plain
    route, which then computes in float64 throughout)."""
    return dtype in DTYPES or (dtype == torch.float64
                               and device.type == "cpu")

# what the build of each default library did: path, seconds, compiler output
BUILD_INFO: dict = {}

# loaded libraries by (stem, extra nvcc defines)
_LIBS: dict = {}


def build_dir() -> str:
    """``build/repro_torch`` at the root of the checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    return os.path.join(root, "build", "repro_torch")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built with nvcc on the machine with the card")
    return path


def _tool(name: str) -> str:
    """A program of the CUDA toolkit beside ``nvcc`` (``cuobjdump``,
    ``cu++filt``)."""
    path = os.path.join(os.path.dirname(_nvcc()), name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found beside nvcc: {path}")
    return path


_RES_FUNCTION = re.compile(r"^\s*Function\s+(\S+?):\s*(.*)$")
_RES_FIELD = re.compile(r"([A-Z_]+(?:\[\d+\])?):(\d+)")


def parse_resource_usage(text: str) -> dict:
    """Mangled kernel name -> its fields (``REG``, ``SHARED`` static shared
    memory plus the card's per-block reservation, ``LOCAL``, ``STACK`` the
    frame spills land in, ...) from the output of
    ``cuobjdump --dump-resource-usage``: a ``Function <name>:`` line, its
    ``KEY:value`` fields on that line or the next."""
    out: dict = {}
    name = None
    for line in text.splitlines():
        m = _RES_FUNCTION.match(line)
        if m:
            name, line = m.group(1), m.group(2)
            out[name] = {}
        elif line.strip().endswith(":"):
            name = None     # another section ("Common:", "Resource usage:")
        if name is not None:
            out[name].update((k, int(v)) for k, v in _RES_FIELD.findall(line))
    return out


def resource_usage(lib_path: str) -> list:
    """Each kernel instance of a built library with its registers, static
    shared memory (with the reservation), local bytes and stack frame, as
    the compiled code records them (``cuobjdump --dump-resource-usage``;
    names demangled with ``cu++filt``), sorted by name."""
    dump = subprocess.run([_tool("cuobjdump"), "--dump-resource-usage",
                           lib_path], capture_output=True, text=True,
                          check=True)
    usage = parse_resource_usage(dump.stdout)
    mangled = sorted(usage)
    names = subprocess.run([_tool("cu++filt"), *mangled], capture_output=True,
                           text=True, check=True).stdout.splitlines()
    if len(names) != len(mangled):
        raise RuntimeError(f"cu++filt gave {len(names)} names for "
                           f"{len(mangled)}")
    return sorted(({"name": n, "mangled": m,
                    "registers": usage[m].get("REG", 0),
                    "shared": usage[m].get("SHARED", 0),
                    "local": usage[m].get("LOCAL", 0),
                    "stack": usage[m].get("STACK", 0)}
                   for n, m in zip(names, mangled)),
                  key=lambda r: r["name"])


def build(stem: str, headers: Sequence[str] = (), *,
          flags: Sequence[str] = ARCH_FLAGS, defines: Sequence[str] = (),
          bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Compile ``csrc/<stem>.cu`` once per content and load it.

    ``headers`` are the ``csrc/`` files it includes (hashed with it);
    ``defines`` (``"NAME=value"``) builds a variant beside the default
    library; ``bind`` sets the C functions' argument and result types.
    """
    key = (stem, tuple(defines))
    if key in _LIBS:
        return _LIBS[key]
    all_flags = tuple(flags) + tuple(f"-D{d}" for d in defines)
    digest = hashlib.sha256()
    for name in (f"{stem}.cu", *headers):
        with open(os.path.join(CSRC, name), "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join(all_flags).encode())
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"lib{stem}_{digest.hexdigest()[:16]}.so")
    log = ""
    t0 = time.perf_counter()
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *all_flags, "-o", tmp, os.path.join(CSRC, f"{stem}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem}.cu "
                               f"({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    bind(lib)
    if not defines:
        BUILD_INFO[stem] = {"path": lib_path,
                            "seconds": time.perf_counter() - t0, "log": log}
    _LIBS[key] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"CUDA {what} launch failed: cudaError {err}")


def forbid_grad(kernel: str, *tensors, why: str) -> None:
    """Raise when grad mode is on and one of ``tensors`` needs a gradient:
    ``kernel``'s CUDA launch returns an output with no autograd node, so a
    gradient through it would be cut silently. ``why`` says where its
    backward stands (ROADMAP.md)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}'s CUDA kernel has no backward ({why}); call it under "
            f"torch.no_grad() or inference_mode, or on tensors that need no "
            f"gradient")


def device_launches(fn: Callable[[], object], part: str,
                    windows: int = 3) -> int:
    """CUDA kernel launches whose name holds ``part`` in one call of ``fn``,
    read with torch.profiler: the most that ``windows`` windows saw (a
    window may lose device records, never add one). Empty kernels launched
    and waited for at a window's start take the records a window loses
    first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = 0
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        best = max(best, sum(e.count for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA
                             and part in e.key))
    return best
