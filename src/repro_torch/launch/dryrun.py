"""Multi-pod dry run: one rank's program of every (arch x shape x mesh) cell,
on ``torch.device("meta")``.

The port of the reference's ``launch/dryrun.py``.  Where the reference
lowers and compiles each cell's step for 256 or 512 fake host devices, this
runs one rank's step of the cell in one process, on meta tensors (shapes
and dtypes, no data: it counts and does not compute; every record says
``"device": "meta"``), under torch's fake process group
(``init_process_group("fake")``) of the mesh's size, which gives the rank
its ``DeviceMesh`` of 256 ranks ``(data 16, model 16)`` or 512 ``(pod 2,
data 16, model 16)``.  The rank is the mesh's last, (15, 15): its causal
query slice is the longest, so its program bounds the step.  The
collectives count their calls and bytes and move nothing on meta tensors
(``distributed/sharding.py``).

The model is built on meta without drawing (``models.layers.MetaGen``) and
held cut like a run's (``models.model.hold_cut``): training by the train
``param_specs`` (FSDP over ``data``, and ``pod`` for the >100B archs on the
multi-pod mesh, TP over ``model``); serving TP-replicated where
``param_count * bytes / 16 < 8e9``, else by the train specs (the
reference's rule).  The batch is cut over the batch axes where they divide
it, as the reference's input specs cut it.  Kernel wrappers run their plain
versions on meta tensors (K13's whole-row form, K14's chunked form
batched over its chunks, the hymba scan's steps without their loop:
``kernels/_build.PLAIN_ON_META``, recorded as ``kernels_on_meta``).

Per cell this writes a JSON record with:
  * ``param_bytes_per_device``, ``state_bytes_per_device`` (train: params,
    moments and the step) and ``cache_bytes_per_device`` (serving): the
    reference's reckoning of each leaf's bytes over the mesh axes its spec
    names (:func:`sharded_bytes`);
  * ``dot_flops``: the rank's matmul FLOPs, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (the reference counts
    dots only too, with XLA's chunked attention);
  * ``collectives``: ``{kind: {"bytes", "count"}}`` from
    ``sharding.collective_log`` (all-gathers count the gathered result,
    psums and reduce-scatters the buffer reduced, ppermutes the bytes sent
    plus received);
  * ``live_bytes``: the rank's resident bytes before the step (its blocks
    of the state, its inputs, its cache) and their peak during it, tracked
    over the meta tensors' storages by a ``TorchDispatchMode``
    (:class:`LiveBytes`; a kernel's plain version counts its outputs, not
    its workspace, which the card's kernel keeps in registers and shared
    memory), and ``fits_80gb``: the counterpart of the reference's
    ``memory_analysis``;
  * ``model_flops_*`` and ``analytic_hbm_bytes_per_dev``
    (``launch/analytic.cell_cost``);
  * ``skipped`` for ``long_500k`` on pure full attention; ``long_500k``
    decodes context-parallel.
The reference's XLA-only keys — ``flops_raw``, ``bytes_accessed_raw``,
``transcendentals``, ``hlo_lines``, ``collectives_raw``, the compile
times — have no meaning here and are left out.

Isolation: the fake group is this process's default group, so the dry run
runs in a process of its own that never starts another group
(``chip_smoke.py`` and the tests run it as a child process).  Artifacts go
to ``artifacts/dryrun_torch/`` (restartable: existing cells are skipped
unless ``--force``); ``launch/roofline.py`` turns them into the roofline
table at the H100's peaks.

  python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh both] [--force]
  python -m repro_torch.launch.dryrun --nekbone --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
import traceback
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCHS, SHAPES, get
from repro_torch.configs import specs as CS
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import _build
from repro_torch.launch import steps as St
from repro_torch.launch.analytic import cell_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M

__all__ = ["ART_DIR", "DEVICE_BYTES", "sharded_bytes", "tree_device_bytes",
           "LiveBytes", "fake_world", "program", "serve_mode", "run_cell",
           "run_nekbone", "main"]

ART_DIR = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
           / "dryrun_torch")
DEVICE_BYTES = 80e9            # an H100's HBM
_PLAIN = {"flash_attn": "kernels.ref.flash_attention_plain",
          "wkv6": "kernels.ref.wkv6_chunked_batched"}


# ---------------------------------------------------------------------------
# bytes from the specs
# ---------------------------------------------------------------------------
def sharded_bytes(shape, dtype: torch.dtype, spec, sizes: dict) -> int:
    """Per-device bytes of an array of ``shape`` laid out by ``spec`` on a
    mesh of axis ``sizes``: the reference's ``_sharded_bytes`` (the whole
    array's bytes over the product of the named axes' sizes)."""
    denom = 1
    for entry in (spec or ()):
        for a in (entry,) if isinstance(entry, str) else entry or ():
            denom *= sizes.get(a, 1)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return int(np.prod(shape, dtype=np.int64) * itemsize // max(denom, 1))


def tree_device_bytes(leaves: dict, specs: dict, sizes: dict,
                      dtype: torch.dtype | None = None) -> int:
    """:func:`sharded_bytes` summed over ``{name: tensor}`` by ``{name:
    spec}`` (each leaf in ``dtype`` where given)."""
    return int(sum(sharded_bytes(t.shape, dtype or t.dtype, specs[k], sizes)
                   for k, t in leaves.items()))


# ---------------------------------------------------------------------------
# the live bytes of one rank
# ---------------------------------------------------------------------------
class LiveBytes(TorchDispatchMode):
    """The bytes of the meta storages that ops made and that are still
    referenced, from ``base`` bytes (what was resident before), and their
    peak.  A storage is live while a tensor that an op returned holds it
    (a view holds its base's); inside :meth:`kernel` the peak is taken
    only on the way out, so a kernel's plain version counts what it
    returns, not its temporaries."""

    def __init__(self, base: int = 0):
        super().__init__()
        self.base = self.now = self.peak = int(base)
        self._live: dict = {}
        self._kernel = 0

    def _drop(self, key):
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.now -= entry[0]
            del self._live[key]

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            self._live[key][1] += 1
        else:
            self._live[key] = [st.nbytes(), 1]
            self.now += st.nbytes()
            if not self._kernel:
                self.peak = max(self.peak, self.now)
        weakref.finalize(t, self._drop, key)

    @contextlib.contextmanager
    def kernel(self):
        self._kernel += 1
        try:
            yield
        finally:
            self._kernel -= 1
            if not self._kernel:
                self.peak = max(self.peak, self.now)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type == "meta":
                self._track(t)
        return out


def _nbytes(tensors) -> int:
    """Bytes of the distinct storages behind ``tensors``."""
    seen = {}
    for t in tensors:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return int(sum(seen.values()))


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------
def fake_world(n_devices: int) -> int:
    """Make this process rank ``n_devices - 1`` of a fake process group of
    ``n_devices`` ranks (replacing a fake group of another size); refuses
    where a real group is initialised.  Returns the rank."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run runs in a process of its own: a "
                               f"{dist.get_backend()} group is initialised")
        if dist.get_world_size() == n_devices:
            return dist.get_rank()
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=n_devices - 1,
                            world_size=n_devices)
    return n_devices - 1


def _mesh(mesh_kind: str):
    multi = mesh_kind == "multi"
    fake_world(512 if multi else 256)
    return make_production_mesh(multi_pod=multi)


@contextlib.contextmanager
def _counting(base: int):
    """FLOPs, collectives and live bytes of the block (the tracker also
    scopes each kernel's plain version on meta)."""
    from torch.utils.flop_counter import FlopCounterMode

    live = LiveBytes(base)
    for k in list(_build.PLAIN_ON_META):
        _build.PLAIN_ON_META[k] = 0
    _build.META_SCOPES.append(live.kernel)
    flops = FlopCounterMode(display=False)
    try:
        with SH.collective_log() as log, flops, live:
            yield flops, log, live
    finally:
        _build.META_SCOPES.remove(live.kernel)


def _record_counts(rec, flops, log, live):
    rec["dot_flops"] = float(flops.get_total_flops())
    rec["collectives"] = {k: {"bytes": int(log.bytes[k]),
                              "count": int(log.counts[k])}
                          for k in sorted(log.counts)}
    rec["live_bytes"] = {"base": live.base, "peak": live.peak}
    rec["fits_80gb"] = live.peak <= DEVICE_BYTES
    rec["kernels_on_meta"] = {k: {"plain": _PLAIN[k], "calls": n}
                              for k, n in _build.PLAIN_ON_META.items() if n}


def _local_batch(mesh, B: int):
    """(rows a rank holds, cut): the batch cut over the batch axes where
    they divide it, as the reference's input specs cut it."""
    n = SH.RULES._size(SH.RULES.dp)
    return (B // n, True) if n > 1 and B % n == 0 else (B, False)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
def _inputs(shape, dtype, device, gen, high=None):
    if device == "meta":
        return _meta(shape, dtype)
    if high is not None:
        return torch.randint(0, high, shape, generator=gen, device=device)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def program(cfg, cell, model, rows: int, cut: bool, *, device="meta",
            context_parallel: bool = False):
    """One rank's step of ``cell`` on ``model`` (held as a run holds it,
    under the active mesh) with ``rows`` of the global batch: ``(run,
    resident)``, ``run()`` the step and ``resident`` the tensors the rank
    holds before it.  On ``device="meta"`` the inputs are shapes; on the
    CPU they are drawn from seed 0 (the tests' real run of the same
    program).  ``cut``: the batch is cut over the batch axes."""
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    B, S = cell.global_batch, cell.seq_len
    text = S - (cfg.img_tokens or 0)
    cdt = L.dtype_of(cfg.compute_dtype)

    def extra(b):
        ex = CS.extra_specs(cfg, b)
        return None if ex is None else {
            k: _inputs(v.shape, cdt, device, gen) for k, v in ex.items()}

    batch_cut = SH.batch_cut if cut else contextlib.nullcontext
    if cell.kind == "train":
        model.requires_grad_(True)
        named = dict(model.named_parameters())
        mdt = L.dtype_of(cfg.opt_moment_dtype)
        state = St.TrainState(
            params=model, step=0,
            mu={k: torch.zeros(p.shape, dtype=mdt, device=p.device)
                for k, p in named.items()},
            nu={k: torch.zeros(p.shape, dtype=mdt, device=p.device)
                for k, p in named.items()})
        tokens = _inputs((B, text + 1), torch.long, device, gen, cfg.vocab)
        ex = extra(B)
        step = St.make_train_step(cfg)
        return (lambda: step(state, {"tokens": tokens}, ex),
                [*named.values(), *state.mu.values(), *state.nu.values()])
    if cell.kind == "prefill":
        tokens = _inputs((rows, text), torch.long, device, gen, cfg.vocab)
        ex = extra(rows)
        fn = St.make_serve_prefill(cfg, max_len=S)

        def run():
            with batch_cut():
                return fn(model, tokens, ex)

        return run, list(model.parameters())
    with batch_cut():
        cache = M.init_cache(cfg, rows, S, device=device,
                             context_parallel=context_parallel)
    tokens = _inputs((rows, 1), torch.long, device, gen, cfg.vocab)

    def run():
        with batch_cut(), torch.inference_mode():
            return M.decode_step(model, cfg, tokens, cache, S - 1,
                                 context_parallel=context_parallel)

    return run, [*model.parameters(), *(t for c in cache for t in c.values())]


def serve_mode(cfg, cell) -> bool:
    """The reference's rule: a serving cell's parameters are TP-replicated
    (held whole over the batch axes) where ``param_count * bytes / 16 <
    8e9``; training and the larger archs are FSDP."""
    dtype_bytes = torch.empty((), dtype=L.dtype_of(
        cfg.param_dtype)).element_size()
    return (cell.kind != "train"
            and cfg.param_count() * dtype_bytes / 16 < 8e9)


def run_cell(arch: str, shape: str, mesh_kind: str, *,
             verbose: bool = True, cfg=None, cell=None, axes=None) -> dict:
    """One rank's step of the cell (module docstring).  ``cfg`` and
    ``cell`` replace the arch's config and the shape's cell, and ``axes``
    (``{name: size}``) the production mesh (the tests' small cells)."""
    cfg = get(arch) if cfg is None else cfg
    cell = SHAPES[shape] if cell is None else cell
    multi = mesh_kind == "multi"
    if axes is None:
        mesh = _mesh(mesh_kind)
    else:
        from torch.distributed.device_mesh import DeviceMesh

        fake_world(int(np.prod(list(axes.values()))))
        mesh = DeviceMesh("cpu", torch.arange(int(np.prod(list(
            axes.values())))).reshape(tuple(axes.values())),
            mesh_dim_names=tuple(axes))
    SH.set_rules(fsdp_pod=multi and cfg.param_count() > 1e11)
    sizes = SH.mesh_axes(mesh)
    n_dev = int(np.prod(list(sizes.values())))
    rank = torch.distributed.get_rank()
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "kind": cell.kind, "n_devices": n_dev, "device": "meta",
           "rank": rank, "coordinate": list(mesh.get_coordinate()),
           "compute_dtype": cfg.compute_dtype,
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "tokens": cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                          else 1)}
    if shape == "long_500k" and cfg.is_pure_full_attention:
        rec["skipped"] = "pure full attention (sub-quadratic rule)"
        return rec

    t0 = time.time()
    serve = serve_mode(cfg, cell)
    rec["serve_param_mode"] = "tp-replicated" if serve else "fsdp"
    B, S = cell.global_batch, cell.seq_len
    cp = shape == "long_500k"
    if cell.kind != "train":
        # the cache's global shapes (no mesh active) and the reference's
        # specs of them
        whole = M.init_cache(cfg, B, S, device="meta")
        cspec = CS.cache_specs(cfg, whole, mesh, context_parallel=cp)
        rec["cache_bytes_per_device"] = sum(
            tree_device_bytes(c, s, sizes) for c, s in zip(whole, cspec))
    with SH.use_mesh(mesh):
        model = M.init_params(L.MetaGen(), cfg)
        whole = dict(model.named_parameters())
        specs = M.param_specs(cfg, model, mesh, serve=serve)
        rec["param_bytes_per_device"] = tree_device_bytes(whole, specs, sizes)
        if cell.kind == "train":
            mdt = L.dtype_of(cfg.opt_moment_dtype)
            rec["state_bytes_per_device"] = (
                rec["param_bytes_per_device"]
                + 2 * tree_device_bytes(whole, specs, sizes, mdt) + 4)
        M.hold_cut(model, cfg, mesh, specs)
        rows, cut = _local_batch(mesh, B)
        rec["batch_rows_per_rank"] = rows if cell.kind != "train" else (
            B // SH.RULES._size(SH.RULES.dp))
        if cell.kind == "decode":
            rec["context_parallel"] = cp
        run, resident = program(cfg, cell, model, rows, cut,
                                context_parallel=cp)
        with _counting(_nbytes(resident)) as counts:
            run()
        _record_counts(rec, *counts)
    rec["time_run_s"] = round(time.time() - t0, 2)
    cc = cell_cost(cfg, cell, n_dev, param_shards=(16 if serve else None))
    rec["model_flops_total"] = cc.model_flops_total
    rec["model_flops_per_dev"] = cc.model_flops_per_dev
    rec["analytic_hbm_bytes_per_dev"] = cc.hbm_bytes_per_dev
    if verbose:
        print(json.dumps({k: rec[k] for k in
                          ("arch", "shape", "mesh", "dot_flops",
                           "model_flops_per_dev", "live_bytes",
                           "time_run_s")}))
        print("collectives:", {k: v["bytes"] for k, v in
                               rec["collectives"].items()}, flush=True)
    return rec


def run_nekbone(mesh_kind: str, nelt_per_device: int = 1024,
                dtype=torch.float32) -> dict:
    """The paper's own app: one rank's CG iteration (the assembled operator
    and the vector ops) of the n=10 case with a (16, 16, 4) element grid a
    rank, the elements over every mesh axis flattened into one z-slab
    ``SolverMesh`` (Nekbone is data-parallel plus a halo).

    ``dtype=torch.bfloat16`` is the beyond-paper variant: the operator is
    memory-bound (Eq. 2), so halving every stream doubles the attainable
    roofline."""
    from repro_torch.core.nekbone import NekboneCase

    multi = mesh_kind == "multi"
    n_dev = 512 if multi else 256
    fake_world(n_dev)
    mesh = SH.solver_mesh()
    grid = (16, 16, 4)
    n = 10
    E_loc = grid[0] * grid[1] * grid[2]
    if E_loc != nelt_per_device:
        raise ValueError(f"the (16, 16, 4) grid a rank holds {E_loc} "
                         "elements")
    E = E_loc * n_dev
    case = NekboneCase(n=n, grid=grid, dtype=dtype, ax_impl="fused",
                       device="cpu")
    case.D = case.D.to("meta")
    op = case.sharded_ax_full(mesh)
    u = _meta((E_loc, n, n, n), dtype)
    g = _meta((E_loc, 6, n, n, n), dtype)
    mask, c = _meta((E_loc, n, n, n), dtype), _meta((E_loc, n, n, n), dtype)
    t0 = time.time()
    with _counting(_nbytes([u, g, mask, c, case.D])) as counts:
        w = op(u, g, mask, grid)
        pap = SH.psum(torch.sum(w * c * u).reshape(1), mesh)
        alpha = 1.0 / pap
        u = u + alpha * w
    itemsize = torch.empty((), dtype=dtype).element_size()
    name = str(dtype).removeprefix("torch.")
    ndof_dev = E * n ** 3 // n_dev
    rec = {"arch": f"nekbone-{name}", "shape": f"e{E}", "mesh": mesh_kind,
           "kind": "cg_iter", "n_devices": n_dev, "device": "meta",
           "rank": torch.distributed.get_rank(), "compute_dtype": name,
           "time_run_s": round(time.time() - t0, 2), "ndof": E * n ** 3,
           "state_bytes_per_device": 4 * E_loc * n ** 3 * itemsize
           + E_loc * 6 * n ** 3 * itemsize,
           # paper Eq. 1 / Eq. 2 per device
           "model_flops_per_dev": float(ndof_dev * (12 * n + 34)),
           "model_flops_total": float(E * n ** 3 * (12 * n + 34)),
           "analytic_hbm_bytes_per_dev": float(30 * ndof_dev * itemsize)}
    _record_counts(rec, *counts)
    print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh",
                                          "dot_flops", "live_bytes")}),
          flush=True)
    return rec


# ---------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCHS) + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--nekbone", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=str(ART_DIR))
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.nekbone:
        for mk in meshes:
            for dtype in (torch.float32, torch.bfloat16):
                rec = run_nekbone(mk, dtype=dtype)
                (out_dir / f"{rec['arch']}__{mk}.json").write_text(
                    json.dumps(rec, indent=1))
        return 0

    if args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        cells = [(args.arch, s) for s in SHAPES]
    elif args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        ap.error("name --arch (and --shape), --all or --nekbone")
    failures = []
    t_all = time.time()
    for mk in meshes:
        for arch, shape in cells:
            tag = f"{arch}__{shape}__{mk}".replace("/", "_")
            path = out_dir / f"{tag}.json"
            if path.exists() and not args.force:
                print(f"skip (exists): {tag}")
                continue
            print(f"=== {tag} ===", flush=True)
            try:
                rec = run_cell(arch, shape, mk)
            except Exception as e:  # record the failure, keep going
                rec = {"arch": arch, "shape": shape, "mesh": mk,
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
                failures.append(tag)
                print(f"FAILED: {tag}: {e}", flush=True)
            path.write_text(json.dumps(rec, indent=1))
    print(f"\nsweep: {time.time() - t_all:.1f} s (CPU)")
    if failures:
        print(f"\n{len(failures)} FAILED cells: {failures}")
        raise SystemExit(1)
    print("\nall requested cells OK")
    return 0


if __name__ == "__main__":
    main()
