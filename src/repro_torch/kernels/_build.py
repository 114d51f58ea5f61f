"""Build the CUDA kernels of ``kernels/csrc/`` with ``nvcc``, at first use.

Each ``csrc/<stem>.cu`` becomes one shared library with a plain C
interface (loaded with ``ctypes``) per dtype of :data:`SOURCES` — ``f64``
and ``f32`` for the Nekbone kernels, and ``bf16`` and ``bf16_ir`` (the two
operand mixes of the bf16 policies: every operand bf16, or bf16 vectors
with x and the operator's data in f32) for all of them, K1 to K12; ``f32``
and ``bf16`` for the LM kernels (K13 ``flash_attn``, K14 ``wkv6``) — compiled
for Hopper only::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -DNEKBONE_REAL_F64 \\
         -o <build>/<stem>_f64-<hash>.so <stem>.cu

The macro (``-DNEKBONE_REAL_BF16_IR`` for ``bf16_ir``) keeps only that
dtype's C entry points ``<stem>_f64`` (or ``_f32``, ``_bf16``,
``_bf16_ir``; ``nekbone_ax_dots`` also exports ``nekbone_ax_pap_<dtype>``),
and with them that dtype's
template instantiations, so the builds run in parallel.  The macro keeps its
first slice's name (``NEKBONE_REAL_``) for every source, so a library's
name and flags depend only on its stem and dtype.  The libraries go to
``build/repro_torch/`` at the root of the checkout (``$REPRO_TORCH_BUILD_DIR`` overrides it), named
by a hash of the sources, the shared header and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.
:func:`build_all` starts one ``nvcc`` per library, all at once, and waits
for them together; ``ptxas``'s register and spill report lands next to
each library as ``<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = ["CSRC", "SOURCES", "DTYPES", "NVCC_FLAGS",
           "LAUNCHES", "BUILD_LAUNCHES", "reset_launches", "split_name",
           "build_dir", "nvcc_path", "build_all", "load", "launch",
           "CHARGE", "charged"]

CSRC = pathlib.Path(__file__).with_name("csrc")
_NEKBONE = ("nekbone_ax", "nekbone_ax_slab", "nekbone_cg_update",
            "nekbone_pcg_update", "nekbone_cheb_apply", "nekbone_interp",
            "nekbone_ax_slab_block", "nekbone_cg_update_block",
            "nekbone_ax_dots", "nekbone_ax_powers", "nekbone_sstep_update")
DTYPES = ("f64", "f32", "bf16", "bf16_ir")
# {stem: the dtypes it is built for}: one library per pair.
SOURCES = {**{stem: DTYPES for stem in _NEKBONE},
           "flash_attn": ("f32", "bf16"), "wkv6": ("f32", "bf16")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches per wrapper since the last reset_launches() (plain ints;
# launch() adds one where a wrapper launches its kernel).  The package's one
# counter, for K1-K12 (kernels/nekbone_ax.py), K13 (kernels/flash_attn.py)
# and K14 (kernels/wkv6.py).
LAUNCHES = {"nekbone_ax": 0, "nekbone_ax_slab": 0, "nekbone_cg_update": 0,
            "nekbone_cg_update_planes": 0, "nekbone_pcg_update": 0,
            "nekbone_pcg_update_planes": 0, "nekbone_cheb_apply": 0,
            "nekbone_interp": 0, "nekbone_ax_slab_block": 0,
            "nekbone_cg_update_block": 0, "nekbone_ax_pap": 0,
            "nekbone_ax_dots": 0, "nekbone_ax_powers": 0,
            "nekbone_sstep_update": 0, "flash_attn": 0, "wkv6": 0}
# The same launches by the build that ran: {C entry point (``<stem>_<dtype>``)
# and the launch's detail, if any (K13 adds its head size, its window,
# ``_noncausal`` where it is not causal, ``_cross`` where Skv != q_offset +
# Sq and ``_qoffset<q_offset>`` where q_offset != 0:
# ``flash_attn_bf16_d64_window1024``, ``flash_attn_bf16_d64_noncausal``,
# ``flash_attn_bf16_d64_noncausal_cross``,
# ``flash_attn_bf16_d64_window1024_qoffset1024``): count}, for the launched
# keys only.
BUILD_LAUNCHES: dict[str, int] = {}


# The stream recorder of obs/drift.py while it measures, else None: an
# object with ``depth`` (wrappers entered and not left) and
# ``charge(name, read_bytes, write_bytes)``.
CHARGE = None


def _tensor_bytes(obj) -> int:
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_tensor_bytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(_tensor_bytes(o) for o in obj.values())
    return 0


def charged(fn):
    """A kernel wrapper that charges :data:`CHARGE`, where one is set, the
    bytes of its tensor operands and of its tensor results, once a call, on
    the CPU (its plain version) as on the card; what runs inside it is not
    charged again."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        rec = CHARGE
        if rec is None:
            return fn(*args, **kwargs)
        reads = _tensor_bytes((args, kwargs))
        rec.depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            rec.depth -= 1
        if rec.depth == 0:
            rec.charge(fn.__name__, reads, _tensor_bytes(out))
        return out

    return wrapper


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    BUILD_LAUNCHES.clear()


def split_name(name: str) -> tuple[str, str]:
    """``<stem>_<dtype>`` -> ``(stem, dtype)``; the dtype may hold an
    underscore (``bf16_ir``)."""
    for dtype in sorted(DTYPES, key=len, reverse=True):
        if name.endswith(f"_{dtype}"):
            return name[:-len(dtype) - 1], dtype
    raise ValueError(f"{name!r} ends in none of the dtypes {DTYPES}")


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


def _flags(dtype: str) -> tuple[str, ...]:
    return (*NVCC_FLAGS, f"-DNEKBONE_REAL_{dtype.upper()}")


def _target(stem: str, dtype: str) -> pathlib.Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(_flags(dtype)).encode())
    return build_dir() / f"{stem}_{dtype}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, pathlib.Path]:
    """Compile every missing library, one ``nvcc`` per library in parallel.

    Returns ``{name: library path}`` with ``name`` the library's C entry
    point, ``<stem>_<dtype>``.  Raises ``RuntimeError`` with the compiler's
    output if any library fails to build.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    targets = {f"{stem}_{dtype}": _target(stem, dtype)
               for stem, dtypes in SOURCES.items() for dtype in dtypes}
    procs = {}
    for name, so in targets.items():
        if so.exists():
            continue
        stem, dtype = split_name(name)
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *_flags(dtype), "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        targets[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            head = "\n".join(log.splitlines()[:40])
            errors.append(f"nvcc failed on {name} (first 40 lines; all "
                          f"in {targets[name].with_suffix('.log')}):\n{head}")
            continue
        os.replace(tmp, targets[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``<stem>_<dtype>``), building all on
    first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            paths = build_all()
            for key, path in paths.items():
                _LIBS[key] = ctypes.CDLL(str(path))
            lib = _LIBS[name]
        return lib


def launch(name: str, argtypes: list, device, args, *,
           library: str | None = None, detail: str = "") -> None:
    """Call the C entry point ``name`` (``<stem>_<dtype>``) of ``library``
    (by default the library of that name) with ``args`` and the current
    stream of ``device``; raise if it returns a CUDA error, else add one to
    ``LAUNCHES[<stem>]`` and to ``BUILD_LAUNCHES[name + detail]``."""
    import torch

    fn = getattr(load(library or name), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[split_name(name)[0]] += 1
    BUILD_LAUNCHES[name + detail] = BUILD_LAUNCHES.get(name + detail, 0) + 1
