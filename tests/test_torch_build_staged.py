"""The staged build of ``kernels/_build.py`` on the CPU, with a stand-in
compiler: a script that takes ``nvcc``'s arguments, writes the niceness,
session and process group it ran in into its output, and sleeps or fails
where the test says.

``start_build`` starts every missing library at once and returns;
``wait_for`` waits for one library alone; ``build_all`` waits for all and
gathers every failure; ``load`` raises a build's failure; ``stop_build``
kills what still compiles.  Each library runs at the niceness of its
place in the order given (``_niceness``: the first four highest), the
libraries not named after those named, in SOURCES' order, in the
caller's session (where the scheduler groups processes by session, a
session of its own would void the niceness) and a process group of its
own."""
from __future__ import annotations

import os
import pathlib
import shutil
import sys
import textwrap
import time

import pytest

from repro_torch.kernels import _build

FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import os, pathlib, sys, time
    args = sys.argv[1:]
    out = pathlib.Path(args[args.index("-o") + 1])
    stem = pathlib.Path([a for a in args if a.endswith(".cu")][0]).stem
    print("ptxas info: stand-in for", stem, flush=True)
    if stem in os.environ.get("FAKE_NVCC_FAIL", "").split(","):
        print("error: stand-in failure of", stem)
        sys.exit(2)
    if stem in os.environ.get("FAKE_NVCC_SLOW", "").split(","):
        import subprocess
        child = subprocess.Popen([sys.executable, "-c",
                                  "import time; time.sleep(60)"])
        pathlib.Path(os.environ["FAKE_NVCC_PIDS"]).write_text(
            f"{{os.getpid()}} {{child.pid}}")
        child.wait()
    out.write_text(f"{{os.nice(0)}} {{os.getsid(0)}} {{os.getpgid(0)}}")
    """)

SOURCES = {"nekbone_ax": ("f64", "f32"), "nekbone_ax_slab": ("f64",),
           "nekbone_cg_update": ("f64", "f32"), "wkv6": ("f32", "bf16")}


@pytest.fixture
def fake(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "SOURCES", SOURCES)
    monkeypatch.setattr(_build, "_JOBS", {})
    monkeypatch.setattr(_build, "_LIBS", {})
    yield tmp_path
    _build.stop_build()


def test_build_all_builds_each_library_at_its_places_niceness(fake):
    # wkv6_bf16 and nekbone_cg_update_f32 named first; the rest in
    # SOURCES' order; "nekbone_ax_bf16" is no library here
    _build.start_build(["wkv6_bf16", "nekbone_ax_bf16",
                        "nekbone_cg_update_f32"])
    paths = _build.build_all()
    order = ["wkv6_bf16", "nekbone_cg_update_f32", "nekbone_ax_f64",
             "nekbone_ax_f32", "nekbone_ax_slab_f64", "nekbone_cg_update_f64",
             "wkv6_f32"]
    assert set(paths) == set(order)
    base = os.nice(0)
    for rank, name in enumerate(order):
        path = paths[name]
        want = (min(19, base + _build._niceness(rank))
                if shutil.which("nice") else base)
        nice, sid, pgid = map(int, path.read_text().split())
        assert nice == want, name
        assert sid == os.getsid(0) and pgid != os.getpgid(0), name
        stem = _build.split_name(name)[0]
        assert "stand-in for " + stem in path.with_suffix(".log").read_text()
        assert not list(path.parent.glob(f"{name}-*.tmp*"))
    assert [_build._niceness(r) for r in (0, 3, 4, 8, 20, 51)] == [
        1, 1, 4, 7, 16, 19]
    assert set(_build.build_seconds()) == set(paths)
    # built libraries are found again, not rebuilt
    before = {n: p.stat().st_mtime_ns for n, p in paths.items()}
    assert _build.start_build() == paths
    assert {n: p.stat().st_mtime_ns for n, p in paths.items()} == before


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie is dead too
    stat = pathlib.Path(f"/proc/{pid}/stat")
    return not (stat.exists() and stat.read_text().split(") ")[1][0] == "Z")


def test_wait_for_returns_one_library_while_others_compile(fake,
                                                           monkeypatch):
    pids = fake / "pids"
    monkeypatch.setenv("FAKE_NVCC_SLOW", "wkv6")
    monkeypatch.setenv("FAKE_NVCC_PIDS", str(pids))
    monkeypatch.setattr(_build, "SOURCES", {**SOURCES, "wkv6": ("f32",)})
    t0 = time.perf_counter()
    _build.start_build()
    path = _build.wait_for("nekbone_ax_f64")
    assert path.exists() and time.perf_counter() - t0 < 30
    slow = _build._JOBS["wkv6_f32"]
    assert slow.proc.poll() is None and not slow.done.is_set()
    while not pids.exists() or len(pids.read_text().split()) < 2:
        assert time.perf_counter() - t0 < 30
        time.sleep(0.05)
    # the stand-in and the compiler it started both end
    nvcc_pid, child_pid = map(int, pids.read_text().split())
    assert _alive(child_pid)
    _build.stop_build()
    assert slow.done.is_set() and slow.error and not slow.target.exists()
    deadline = time.perf_counter() + 10
    while _alive(child_pid) and time.perf_counter() < deadline:
        time.sleep(0.05)
    assert not _alive(child_pid) and not _alive(nvcc_pid)


def test_a_failed_build_raises_its_log_in_wait_for_build_all_and_load(
        fake, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "nekbone_ax_slab")
    with pytest.raises(RuntimeError, match="stand-in failure of "
                                           "nekbone_ax_slab"):
        _build.wait_for("nekbone_ax_slab_f64")
    with pytest.raises(RuntimeError, match="nvcc failed on "
                                           "nekbone_ax_slab_f64"):
        _build.build_all()
    with pytest.raises(RuntimeError, match="nekbone_ax_slab_f64"):
        _build.load("nekbone_ax_slab_f64")
    assert _build.wait_for("nekbone_ax_f64").exists()
