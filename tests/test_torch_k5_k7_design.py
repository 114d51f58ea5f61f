"""The designs of K5 and K7: the CG update as a persistent walker that
stages the next work item's x, p, r and own copy of w in a ring in shared
memory, K7 over the lane-major work items of its b right-hand sides, on the
CPU.

* ``kernels.nekbone_ax.k5_plan`` and ``k7_plan``: every work item is owned by
  exactly one block, in contiguous ranges (z-major elements for K5; item
  l E + e, lane-major, for K7, so a range may cross into the next lane);
  the grid is on the card at once (one wave), so all b lanes are in flight
  together; the copy path is TMA's bulk copy exactly where every operand's
  bytes per item are a multiple of 16 (n even) and the pointers are
  16-byte aligned, per-thread cp.async otherwise; the dynamic shared memory
  is what the ring's stages hold, all four operands wherever one block of
  that ring fits an SM; a size no ring fits raises.  The occupancy of a
  block comes from an argument (on the card, CUDA's occupancy calculator);
  here from a model of the H100's limits at a few register counts.
* The planner's constants are the CUDA sources' (the operand order, the
  launch, one item function for both kernels, the C signatures).
* On the CPU the K5 and K7 wrappers are their plain versions.  (The plain
  versions against the JAX kernels: tests/test_torch_cg_fused_v2.py,
  tests/test_torch_cg_block.py and tests/test_torch_ir.py.)
"""
import itertools
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.core.nekbone import NekboneCase as TorchCase
from repro_torch.kernels import nekbone_ax as K
from repro_torch.kernels import ops

CSRC = pathlib.Path(K.__file__).with_name("csrc")

# The H100's limits as the occupancy calculator applies them (as in
# tests/test_torch_k4_k3_design.py): 228 KB of shared memory an SM, 1 KB of
# it reserved for each block, 65536 registers, 2048 threads and at most 32
# blocks an SM; a block's threads take registers in whole warps.
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
SMS = 132
# registers a thread: the runtime's figure is read on the card; the plans
# are held at a few counts around what the update kernels need
REGISTERS = (40, 64, 96)


def static_smem(n, mix):
    """block_sum_shfl's two buffers of n^2 values of A and the ring's
    barriers."""
    acc = 8 if mix == "f64" else 4
    return 2 * n * n * acc + 8 * 4


def occupancy(n, regs, static):
    """blocks_per_sm(dyn) of an n x n thread block with these resources."""
    warps = -(-n * n // 32)

    def blocks_per_sm(dyn):
        if static + dyn > SMEM_PER_BLOCK:
            return 0
        return min(32, 2048 // (32 * warps), 65536 // (regs * 32 * warps),
                   SMEM_PER_SM // (static + dyn + 1024))
    return blocks_per_sm


def _plan(kernel, E, n, mix, *, b=4, regs=64, aligned=True):
    static = static_smem(n, mix)
    fit = occupancy(n, regs, static)
    kw = dict(aligned=aligned)
    if kernel == "k7":
        kw["b"] = b
        planner = K.k7_plan
    else:
        planner = K.k5_plan
    plan = planner(E, n, mix, SMS, fit, SMEM_PER_BLOCK - static, **kw)
    return plan, fit, static


def _items(kernel, E, b):
    return E * (b if kernel == "k7" else 1)


CASES = list(itertools.product(("k5", "k7"), (1, 45, 1024, 4096),
                               (2, 3, 5, 10, 16), tuple(K.MIXES)))


@pytest.mark.parametrize("kernel,E,n,mix", CASES)
def test_update_plan_covers_every_item_once(kernel, E, n, mix):
    """Block k owns items [k m, (k + 1) m), cut at the item count; K7's
    item q is element q mod E of lane q div E, so every (lane, element)
    pair is owned once and a block's elements are consecutive within each
    lane it touches."""
    b = 3
    plan, _, _ = _plan(kernel, E, n, mix, b=b)
    items = _items(kernel, E, b)
    m = plan.per_block
    ranges = [(k * m, min((k + 1) * m, items)) for k in range(plan.grid)]
    assert ranges[0][0] == 0 and ranges[-1][1] == items
    for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
        assert hi == lo                    # contiguous, no gap, no overlap
    assert all(lo < hi for lo, hi in ranges)   # every block owns an item
    owned = [divmod(q, E) for lo, hi in ranges for q in range(lo, hi)]
    assert sorted(owned) == [(lane, e) for lane in range(items // E)
                             for e in range(E)]
    for lo, hi in ranges:
        for lane in {q // E for q in range(lo, hi)}:
            es = [q % E for q in range(lo, hi) if q // E == lane]
            assert es == list(range(es[0], es[0] + len(es)))


@pytest.mark.parametrize("kernel,E,n,mix", CASES)
def test_update_plan_ring_and_path(kernel, E, n, mix):
    """The dynamic shared memory is what the ring's stages hold (never above
    a block's 232,448 bytes); the copy path is bulk exactly for even n; the
    four operands are staged wherever one block of their ring fits an SM,
    at the residency that ring allows; the grid is on the card at once."""
    plan, fit, static = _plan(kernel, E, n, mix)
    ops_ = K.k5_operands(n, mix)
    assert plan.operands == ("x", "p", "r", "w") == tuple(ops_)
    assert plan.bulk == (n % 2 == 0) and plan.copy == (
        "bulk" if n % 2 == 0 else "cp.async")
    assert plan.bulk == all(v % 16 == 0 for v in ops_.values())
    assert plan.stages == K.STAGES >= 2
    slots = {k: K.walk_slot_bytes(v, plan.bulk) for k, v in ops_.items()}
    assert plan.smem_bytes == plan.stages * sum(slots[k]
                                                for k in plan.staged)
    assert plan.smem_bytes + static <= SMEM_PER_BLOCK
    assert plan.grid <= SMS * plan.blocks_per_sm
    assert plan.blocks_per_sm == fit(plan.smem_bytes) >= 1
    ring = plan.stages * sum(slots.values())
    if fit(ring) >= 1:
        assert plan.staged == tuple(ops_)
        assert plan.blocks_per_sm == fit(ring)


@pytest.mark.parametrize("kernel,mix,regs", itertools.product(
    ("k5", "k7"), tuple(K.MIXES), REGISTERS))
def test_update_plan_paper_case_one_wave(kernel, mix, regs):
    """The paper case (E = 1024, n = 10; K7 at b = 1..4) on 132 SMs: every
    block on the card at once, each owning ceil(items / (132 x blocks an
    SM)) items, all four operands staged by TMA bulk copies: 2 x 32,000
    bytes in fp64, 2 x 16,000 in f32, 2 x 8,000 in bf16 and 2 x 10,000 in
    bf16_ir (x in f32); fp64 three blocks an SM (the ring's shared memory),
    at every register count."""
    for b in ((1, 2, 3, 4) if kernel == "k7" else (1,)):
        plan, _, _ = _plan(kernel, 1024, 10, mix, b=b, regs=regs)
        items = 1024 * b
        assert plan.grid <= SMS * plan.blocks_per_sm
        assert plan.per_block == -(-items // (SMS * plan.blocks_per_sm))
        assert plan.grid == -(-items // plan.per_block)
        assert plan.bulk and plan.staged == ("x", "p", "r", "w")
        stage = {"f64": 32000, "f32": 16000, "bf16": 8000,
                 "bf16_ir": 10000}[mix]
        assert plan.smem_bytes == 2 * stage
        if mix == "f64":
            assert plan.blocks_per_sm == 3
    # E = 4096 too: one wave, the walk several items deep
    plan, _, _ = _plan(kernel, 4096, 10, mix, regs=regs)
    assert plan.grid <= SMS * plan.blocks_per_sm and plan.per_block >= 2


def test_update_plan_k7_lanes_in_flight_together():
    """K7 at b = 4 on the paper case: the one wave's blocks hold items of
    every lane, each lane spread over about a quarter of the grid; the
    lanes are not walked one after another."""
    plan, _, _ = _plan("k7", 1024, 10, "f64", b=4)
    m = plan.per_block
    lanes_of = [{q // 1024 for q in range(k * m, min((k + 1) * m, 4096))}
                for k in range(plan.grid)]
    blocks = {lane: sum(lane in s for s in lanes_of) for lane in range(4)}
    assert all(abs(v - plan.grid / 4) <= 2 for v in blocks.values())
    assert plan.grid <= SMS * plan.blocks_per_sm   # all resident at once


@pytest.mark.parametrize("kernel,n,mix", itertools.product(
    ("k5", "k7"), (2, 3, 4, 5, 10, 11, 16), tuple(K.MIXES)))
def test_update_plan_bulk_only_where_aligned(kernel, n, mix):
    """A pointer off 16-byte alignment takes the cp.async path at any n,
    with the margin of its copy window in every slot; the bulk path at
    n = 10 in every build, and not at n = 5 in fp64 (1,000 bytes an
    item)."""
    plan, _, _ = _plan(kernel, 1024, n, mix, aligned=False)
    assert not plan.bulk and plan.copy == "cp.async"
    ops_ = K.k5_operands(n, mix)
    for k in plan.staged:
        slot = K.walk_slot_bytes(ops_[k], False)
        assert slot % 16 == 0 and slot >= ops_[k] + 16
    aligned, _, _ = _plan(kernel, 1024, n, mix)
    assert aligned.bulk == (n % 2 == 0)
    if (n, mix) == (5, "f64"):
        assert K.k5_operands(5, "f64")["x"] == 1000 and not aligned.bulk


def test_update_plan_raises_where_no_ring_fits():
    for kernel in ("k5", "k7"):
        kw = dict(b=2) if kernel == "k7" else {}
        planner = K.k7_plan if kernel == "k7" else K.k5_plan
        with pytest.raises(ValueError, match="no ring"):
            planner(1024, 10, "f64", SMS, lambda dyn: 0, SMEM_PER_BLOCK,
                    **kw)
        # not even the smallest operand's two stages fit a block
        least = min(K.walk_slot_bytes(v, True)
                    for v in K.k5_operands(16, "f64").values())
        with pytest.raises(ValueError, match="n=16, f64"):
            planner(1024, 16, "f64", SMS, lambda dyn: 4, 2 * least - 1,
                    **kw)
        for bad in (dict(E=0), dict(sm_count=0)):
            args = dict(E=1024, sm_count=SMS) | bad
            with pytest.raises(ValueError):
                planner(args["E"], 10, "f64", args["sm_count"],
                        lambda dyn: 2, SMEM_PER_BLOCK, **kw)
    with pytest.raises(ValueError, match="b=0"):
        K.k7_plan(1024, 10, "f64", SMS, lambda dyn: 2, SMEM_PER_BLOCK, b=0)


def test_update_plan_launch_ints():
    plan, _, _ = _plan("k5", 1024, 10, "f64")
    assert plan.staged_mask == 0b1111
    assert plan.launch_ints == (plan.per_block, plan.grid, K.STAGES, 15, 1)
    k7, _, _ = _plan("k7", 1024, 5, "f64", b=4)
    assert k7.launch_ints[2:] == (K.STAGES, 15, 0)


# ---------------------------------------------------------------------------
# The planner's constants are the sources'
# ---------------------------------------------------------------------------
def _entry_ints(source: str, name: str) -> int:
    """The int parameters of the C entry point ``name`` in ``source``."""
    sig = re.search(rf'extern "C" int {name}##SUFFIX\((.*?)\)',
                    source, re.S).group(1)
    return len(re.findall(r"\bint \w+", sig))


def test_update_constants_are_the_sources():
    common = (CSRC / "common.cuh").read_text()
    k5 = (CSRC / "nekbone_cg_update.cu").read_text()
    k7 = (CSRC / "nekbone_cg_update_block.cu").read_text()
    # the ring's operands: x, p, r, w, x in X and the rest in S
    assert "const void* const src[4] = {a.x, a.p, a.r, a.w};" in common
    assert "bytes[0] = N * N * N * kX;" in common
    assert "bytes[1] = bytes[2] = bytes[3] = N * N * N * kS;" in common
    assert K.k5_operands(10, "f64") == {"x": 8000, "p": 8000, "r": 8000,
                                        "w": 8000}
    assert K.k5_operands(10, "bf16_ir") == {"x": 4000, "p": 2000,
                                            "r": 2000, "w": 2000}
    # lane-major items: lane q / E, element q mod E
    assert "lane = q / E;" in common
    assert "walk_range(E * a.lanes, a.plan.per_block, first, last);" in common
    # one walker and one item function for both; K5 is one lane
    for src in (k5, k7):
        # the walk with every operand staged by bulk copies known at
        # compile time, else the general one
        assert "if (a.plan.bulk && a.plan.staged == 15)\n" \
            "    cg_update_walk<N, true>(a, full, ring_bytes, red);\n" \
            "  else\n" \
            "    cg_update_walk<N, false>(a, full, ring_bytes, red);" in src
        assert "<<<E, dim3(N, N)" not in src
        assert "<<<grid, dim3(N, N), dyn, stream>>>" in src
        assert "asm volatile" not in src
    assert "/*lanes=*/1" in k5
    assert common.count("cg_update_item<N, kBulkAll>(a, ring, ring.base + s "
                        "* ring.stage_bytes, q,") == 1
    # the C signatures the wrappers pass
    assert K._ARGTYPES["nekbone_cg_update"] == \
        [K._P] * 11 + [K._I] * _entry_ints(k5, "nekbone_cg_update_") + [K._P]
    assert K._ARGTYPES["nekbone_cg_update_block"] == \
        [K._P] * 11 + [K._I] * _entry_ints(k7, "nekbone_cg_update_block_") \
        + [K._P]
    for stem in ("nekbone_cg_update", "nekbone_cg_update_block"):
        assert f'extern "C" int {stem}_query_##SUFFIX(int n, int resident,' \
            in (k5 if stem == "nekbone_cg_update" else k7)
        assert K._WALK_PLANNERS[stem] in (K.k5_plan, K.k7_plan)
    # the cp.async path takes a bf16 lane view 2 bytes off a 4-byte
    # boundary (its window reads from the unit that holds the first byte)
    assert "const int unit = any_head ? size[q] : size[q] < 4 ? 4 : size[q];" \
        in common
    assert "walk_plan_ok(a.plan, items, grid, src, bytes, size,\n" \
        "                      /*any_head=*/true);" in common
    # sum_xyz, block_sum and the other helpers are untouched: the new
    # gather lives beside sum_xyz_cg
    assert "sum_xyz_nc" not in common[:common.index("sum_xyz_cg")]


# ---------------------------------------------------------------------------
# The wrappers on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,grid,b", [(4, (2, 2, 2), 1), (4, (2, 2, 2), 3),
                                      (3, (3, 3, 5), 2)])
def test_k5_k7_wrappers_on_cpu_are_the_plain_versions(n, grid, b):
    rng = np.random.default_rng(24)
    case = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    E, n3 = case.mesh.nelt, n ** 3
    _, (cx, cy, cz) = ops.slab_axis_factors(grid, n, torch.float64, "cpu")
    X, P, R, W = (torch.as_tensor(rng.normal(size=(b, E, n3)))
                  for _ in range(4))
    alpha = torch.as_tensor(rng.normal(size=b))
    got = K.nekbone_cg_update_cuda(X[0], P[0], R[0], W[0], alpha[:1], cx,
                                   cy, cz, n=n)
    want = K.nekbone_cg_update_plain(X[0], P[0], R[0], W[0], alpha[:1], cx,
                                     cy, cz, n=n)
    assert all(torch.equal(a, z) for a, z in zip(got, want))
    got = K.nekbone_cg_update_block_cuda(X, P, R, W, alpha, cx, cy, cz, n=n)
    want = K.nekbone_cg_update_block_plain(X, P, R, W, alpha, cx, cy, cz,
                                           n=n)
    assert all(torch.equal(a, z) for a, z in zip(got, want))
    assert got[2].shape == (b, E)
