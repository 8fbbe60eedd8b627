"""Builds the port's CUDA sources (``dmhomo_torch/csrc/*.cu``) with ``nvcc``
for sm_90a into shared libraries with a plain C interface, at first use,
under ``build/kernels/`` of the checkout (once per source content)."""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_library(source: Path, stem: str) -> Path:
    """Compile ``source`` for sm_90a (once per source content) and return the
    library's path.  nvcc's ``-Xptxas -v`` report goes to a ``.log`` beside it."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


# an atomic or reduction-to-memory instruction (global, shared or generic) in
# cuobjdump's SASS listing, predicated or not; REDUX (a warp reduction in
# registers) is not one
_ATOMIC = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?(?:ATOMG?|ATOMS|REDG?|REDAS)[.\s]")
# a tensor-core instruction: HMMA (mma.sync) or HGMMA (wgmma)
_TENSOR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?HG?MMA[.\s]")
_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")


def count_instructions(sass: str, name_part: str, pattern: "re.Pattern") -> dict:
    """Lines of a SASS listing matching ``pattern`` per function whose
    (mangled) name contains ``name_part``: name -> count, every such
    function listed."""
    counts, name = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = m.group(1) if name_part in m.group(1) else None
            if name is not None:
                counts.setdefault(name, 0)
        elif name is not None and pattern.search(line):
            counts[name] += 1
    return counts


def count_atomics(sass: str, name_part: str) -> dict:
    """Atomic instructions (ATOM, ATOMG, ATOMS, RED, REDG, REDAS) per function
    of a SASS listing whose (mangled) name contains ``name_part``."""
    return count_instructions(sass, name_part, _ATOMIC)


def count_tensor_core(sass: str, name_part: str) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) per function of a SASS listing
    whose (mangled) name contains ``name_part``."""
    return count_instructions(sass, name_part, _TENSOR)


def sass(lib: Path) -> str:
    """The machine code (sm_90a SASS) built into ``lib``, disassembled by the
    toolkit's ``cuobjdump`` beside nvcc."""
    tool = Path(nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({proc.returncode}): {proc.stderr}")
    return proc.stdout


def atomic_instructions(lib: Path, name_part: str) -> dict:
    """:func:`count_atomics` of the machine code built into ``lib``."""
    return count_atomics(sass(lib), name_part)


def tensor_core_instructions(lib: Path, name_part: str) -> dict:
    """:func:`count_tensor_core` of the machine code built into ``lib``."""
    return count_tensor_core(sass(lib), name_part)
