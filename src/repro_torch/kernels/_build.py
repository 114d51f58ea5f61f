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
:func:`start_build` starts one ``nvcc`` per missing library, all at once,
and returns; each runs under ``nice`` at a level that grows with its
place in the order the caller gives (by default :data:`SOURCES`' order),
so that the first needed finish first and a caller can work with those
while the rest compile.  :func:`wait_for` waits for one
library, :func:`build_all` for all of them; :func:`load` waits for the one
it loads, starting the build if none is running; :func:`stop_build` kills
what is still compiling.  ``ptxas``'s register and spill report lands next
to each library as ``<name>-<hash>.log``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import signal
import subprocess
import threading
import time

__all__ = ["CSRC", "SOURCES", "DTYPES", "NVCC_FLAGS",
           "LAUNCHES", "BUILD_LAUNCHES", "reset_launches", "split_name",
           "build_dir", "nvcc_path", "start_build", "wait_for",
           "build_all", "build_seconds", "stop_build", "load", "launch",
           "CHARGE", "charged", "PLAIN_ON_META", "META_SCOPES",
           "plain_on_meta"]

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

# Calls whose tensors lay on torch.device("meta") (the dry run,
# launch/dryrun.py), by kernel: the wrapper ran a plain version there, on
# shapes alone, and launched nothing.  META_SCOPES holds the context
# managers entered around each such call (the dry run's memory tracker: a
# kernel's workspace on the card is its tiles, not the program's live
# memory).
PLAIN_ON_META: dict[str, int] = {}
META_SCOPES: list = []


@contextlib.contextmanager
def plain_on_meta(name: str):
    """Around a wrapper's plain version on meta tensors: counts the call in
    :data:`PLAIN_ON_META` and enters :data:`META_SCOPES`."""
    PLAIN_ON_META[name] = PLAIN_ON_META.get(name, 0) + 1
    with contextlib.ExitStack() as stack:
        for scope in META_SCOPES:
            stack.enter_context(scope())
        yield


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


def _niceness(rank: int) -> int:
    """The ``nice`` level of the library at place ``rank`` of a build's
    order: 1 for the first four, 3 more for each next four, at most 19
    (a step of 3 about halves a process's share of a busy CPU)."""
    return min(19, 1 + 3 * (rank // 4))


class _Job:
    """One library's ``nvcc``: a thread waits for it, moves the library
    into place if it built, and sets ``done``."""

    def __init__(self, name: str, target: pathlib.Path, cmd: list[str]):
        self.name, self.target = name, target
        self.tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        self.log = target.with_suffix(".log")
        self.error: str | None = None
        self.seconds: float | None = None
        self.done = threading.Event()
        self.t0 = time.perf_counter()
        with open(self.log, "w") as out:
            # a process group of its own, so that stop_build kills nvcc's
            # children too; the caller's session, so that ``nice`` ranks
            # it below the caller (a session of its own would be a
            # scheduling group of its own, as strong as the caller's)
            self.proc = subprocess.Popen([*cmd, "-o", str(self.tmp)],
                                         stdout=out,
                                         stderr=subprocess.STDOUT,
                                         process_group=0)
        threading.Thread(target=self._finish, daemon=True).start()

    def _finish(self) -> None:
        rc = self.proc.wait()
        self.seconds = time.perf_counter() - self.t0
        if rc == 0:
            os.replace(self.tmp, self.target)
        else:
            head = "\n".join(self.log.read_text().splitlines()[:40])
            self.error = (f"nvcc failed on {self.name} (exit {rc}; first 40 "
                          f"lines, all in {self.log}):\n{head}")
        self.done.set()


# The libraries start_build() compiles, by name, while the process lives.
_JOBS: dict[str, _Job] = {}
_JOBS_LOCK = threading.Lock()


def _targets() -> dict[str, pathlib.Path]:
    return {f"{stem}_{dtype}": _target(stem, dtype)
            for stem, dtypes in SOURCES.items() for dtype in dtypes}


def start_build(order: list[str] | None = None) -> dict[str, pathlib.Path]:
    """Start one ``nvcc`` per library that is neither built nor compiling,
    all at once, and return ``{name: library path}`` without waiting
    (``name`` is the library's C entry point, ``<stem>_<dtype>``).

    ``order`` lists the libraries the caller needs first, first; the rest
    follow in :data:`SOURCES`' order.  Each ``nvcc`` runs under ``nice``
    at its place's level (:func:`_niceness`), so that on a busy CPU the
    libraries finish about in that order."""
    build_dir().mkdir(parents=True, exist_ok=True)
    targets = _targets()
    ranked = list(dict.fromkeys([n for n in order or () if n in targets]
                                + list(targets)))
    nice = shutil.which("nice")
    with _JOBS_LOCK:
        for rank, name in enumerate(ranked):
            so, job = targets[name], _JOBS.get(name)
            if so.exists() or (job is not None and job.error is None):
                continue
            stem, dtype = split_name(name)
            cmd = [nvcc_path(), *_flags(dtype), str(CSRC / f"{stem}.cu")]
            if nice:
                cmd = [nice, "-n", str(_niceness(rank)), *cmd]
            _JOBS[name] = _Job(name, so, cmd)
    return targets


def wait_for(name: str) -> pathlib.Path:
    """The path of library ``name``, once built (starting the build if it
    is neither built nor compiling); raises ``RuntimeError`` with the
    compiler's output if it failed."""
    target = _target(*split_name(name))
    with _JOBS_LOCK:
        job = _JOBS.get(name)
    if job is None:
        if target.exists():
            return target
        start_build()
        with _JOBS_LOCK:
            job = _JOBS[name]
    job.done.wait()
    if job.error is not None:
        raise RuntimeError(job.error)
    return target


def build_all() -> dict[str, pathlib.Path]:
    """Build every missing library (one ``nvcc`` each, all at once) and
    wait for all of them.

    Returns ``{name: library path}``.  Raises ``RuntimeError`` with the
    compiler's output if any library fails to build.
    """
    targets = start_build()
    errors = []
    for name in targets:
        try:
            wait_for(name)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def build_seconds() -> dict[str, float]:
    """``{name: seconds from its nvcc's start to its end}`` of the
    libraries this process compiled and finished."""
    with _JOBS_LOCK:
        return {name: job.seconds for name, job in _JOBS.items()
                if job.seconds is not None}


def stop_build() -> None:
    """Kill every ``nvcc`` of this process that is still running, with
    the compilers it started."""
    with _JOBS_LOCK:
        jobs = list(_JOBS.values())
    for job in jobs:
        if job.proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(job.proc.pid, signal.SIGKILL)
    for job in jobs:
        job.done.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``<stem>_<dtype>``), once built (every
    missing library starts compiling at the first call)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(wait_for(name)))
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
