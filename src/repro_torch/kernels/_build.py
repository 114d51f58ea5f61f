"""Build the CUDA kernels of ``kernels/csrc/`` with ``nvcc``, at first use.

Each ``csrc/*.cu`` becomes one shared library with a plain C interface
(loaded with ``ctypes``), compiled for Hopper only::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <build>/<stem>-<hash>.so <stem>.cu

The libraries go to ``build/repro_torch/`` at the root of the checkout
(``$REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash of the sources,
the shared header and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  :func:`build_all` starts one ``nvcc``
per source, all at once, and waits for them together; ``ptxas``'s register
and spill report lands next to each library as ``<stem>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = ["CSRC", "SOURCES", "NVCC_FLAGS", "build_dir", "nvcc_path",
           "build_all", "load"]

CSRC = pathlib.Path(__file__).with_name("csrc")
SOURCES = ("nekbone_ax", "nekbone_ax_slab", "nekbone_cg_update")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch are built on the machine "
                       "that has the card")


def _target(stem: str) -> pathlib.Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, pathlib.Path]:
    """Compile every missing library, one ``nvcc`` per source in parallel.

    Returns ``{stem: library path}``.  Raises ``RuntimeError`` with the
    compiler's output if any source fails to build.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    targets = {stem: _target(stem) for stem in SOURCES}
    procs = {}
    for stem, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    errors = []
    for stem, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        targets[stem].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            head = "\n".join(log.splitlines()[:40])
            errors.append(f"nvcc failed on {stem}.cu (first 40 lines; all "
                          f"in {targets[stem].with_suffix('.log')}):\n{head}")
            continue
        os.replace(tmp, targets[stem])
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, building all on first use."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            paths = build_all()
            for name, path in paths.items():
                _LIBS[name] = ctypes.CDLL(str(path))
            lib = _LIBS[stem]
        return lib
