"""The designs of K4 and K3 (with K2): persistent blocks that walk a
contiguous range of elements and stage the next element's operands in a
ring in shared memory, on the CPU.

* ``kernels.nekbone_ax.k4_plan`` and ``k3_plan``: every element is owned by
  exactly one block, in contiguous z-major ranges; the grid is on the card
  at once (one wave); the copy path is TMA's bulk copy exactly where every
  operand's bytes and offsets are multiples of 16 (n even) and the
  pointers are 16-byte aligned, per-thread cp.async otherwise; the dynamic
  shared memory is what the ring's stages hold; the residency is the most
  blocks an SM the registers allow at which some staged set fits, and the
  staged set the largest at that residency; a size no ring fits raises.  The occupancy of a block comes from an argument (on the card,
  CUDA's occupancy calculator); here from a model of the H100's limits.
* The planner's constants are the CUDA sources' (the operand order, the
  slot bytes, the ring's depth).
* On the CPU the K4, K3 and K2 wrappers are their plain versions.  (The
  plain versions against the JAX kernels: tests/test_torch_cg_fused_v2.py
  and tests/test_torch_cg_v1.py.)
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

# The H100's limits as the occupancy calculator applies them: 228 KB of
# shared memory an SM, 1 KB of it reserved for each block, 65536 registers
# and at most 32 blocks an SM; a block's threads take registers in whole
# warps.
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
SMS = 132
PLANNERS = {"k4": (K.k4_plan, K.k4_operands),
            "k3": (K.k3_plan, K.k3_operands)}


def registers(n, mix):
    """The walkers' registers a thread at their cap (csrc/common.cuh
    kWalkMinBlocks): as many blocks an SM as 256 threads (fp64) or 512
    (the 4-byte accumulation type) fill, at least one, at most 255."""
    threads = -(-n * n // 32) * 32
    blocks = max(1, (256 if mix == "f64" else 512) // threads)
    return min(255, 65536 // (blocks * threads) // 8 * 8)


def static_smem(n, mix, kernel):
    """AxShared (five n x n layers), the block sums and the barriers."""
    acc = 8 if mix == "f64" else 4
    return (5 + (2 if kernel == "k3" else 1)) * n * n * acc + 8 * 4


def occupancy(threads, regs, static):
    """blocks_per_sm(dyn) of a kernel with these resources."""
    warps = -(-threads // 32)

    def blocks_per_sm(dyn):
        if static + dyn > SMEM_PER_BLOCK:
            return 0
        return min(32, 65536 // (regs * 32 * warps),
                   SMEM_PER_SM // (static + dyn + 1024))
    return blocks_per_sm


def _plan(kernel, E, n, mix, *, aligned=True, sm_count=SMS):
    planner, _ = PLANNERS[kernel]
    static = static_smem(n, mix, kernel)
    fit = occupancy(n * n, registers(n, mix), static)
    plan = planner(E, n, mix, sm_count, fit, SMEM_PER_BLOCK - static,
                   aligned=aligned)
    return plan, fit, static


CASES = list(itertools.product(("k4", "k3"), (1, 45, 1024, 4096),
                               (2, 3, 5, 10, 16), tuple(K.MIXES)))


@pytest.mark.parametrize("kernel,E,n,mix", CASES)
def test_walk_plan_covers_every_element_once(kernel, E, n, mix):
    plan, _, _ = _plan(kernel, E, n, mix)
    m = plan.per_block   # block b owns [b m, (b + 1) m), cut at E
    ranges = [(b * m, min((b + 1) * m, E)) for b in range(plan.grid)]
    assert ranges[0][0] == 0 and ranges[-1][1] == E
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c                      # contiguous, no gap, no overlap
    assert all(a < b for a, b in ranges)   # every block owns an element
    assert sum(b - a for a, b in ranges) == E


@pytest.mark.parametrize("kernel,E,n,mix", CASES)
def test_walk_plan_ring_and_path(kernel, E, n, mix):
    """The dynamic shared memory is what the ring's stages hold (never
    above a block's 232,448 bytes); the copy path is bulk exactly for even
    n; the residency is the most blocks an SM at which some staged set
    fits, at most what the registers allow, and the staged set the one
    with the most bytes at that residency; the grid is on the card at
    once."""
    _, operands = PLANNERS[kernel]
    plan, fit, static = _plan(kernel, E, n, mix)
    ops_ = operands(n, mix)
    assert plan.operands == tuple(ops_)
    assert plan.bulk == (n % 2 == 0) and plan.copy == (
        "bulk" if n % 2 == 0 else "cp.async")
    assert plan.bulk == all(b % 16 == 0 for b in ops_.values())
    assert plan.stages == K.STAGES >= 2
    assert plan.staged and set(plan.staged) <= set(ops_)
    slots = {k: K.walk_slot_bytes(b, plan.bulk) for k, b in ops_.items()}
    assert plan.smem_bytes == plan.stages * sum(slots[k]
                                                for k in plan.staged)
    assert plan.smem_bytes + static <= SMEM_PER_BLOCK
    assert plan.grid <= SMS * plan.blocks_per_sm
    subsets = [sub for r in range(1, 4)
               for sub in itertools.combinations(ops_, r)]

    def dyn(sub):
        return plan.stages * sum(slots[k] for k in sub)
    reach = max(min(fit(dyn(sub)), fit(0)) for sub in subsets)
    assert plan.blocks_per_sm == fit(plan.smem_bytes) == reach >= 1
    best = max(sum(ops_[k] for k in sub) for sub in subsets
               if fit(dyn(sub)) >= reach)
    assert sum(ops_[k] for k in plan.staged) == best


@pytest.mark.parametrize("kernel,n,mix", itertools.product(
    ("k4", "k3"), (2, 3, 4, 5, 10, 11, 16), tuple(K.MIXES)))
def test_walk_plan_bulk_only_where_aligned(kernel, n, mix):
    """A pointer off 16-byte alignment takes the cp.async path at any n,
    with the margin of its copy window in every slot."""
    _, operands = PLANNERS[kernel]
    plan, _, _ = _plan(kernel, 1024, n, mix, aligned=False)
    assert not plan.bulk and plan.copy == "cp.async"
    ops_ = operands(n, mix)
    for k in plan.staged:
        slot = K.walk_slot_bytes(ops_[k], False)
        assert slot % 16 == 0 and slot >= ops_[k] + 16


@pytest.mark.parametrize("mix", tuple(K.MIXES))
def test_walk_plan_paper_case_one_wave(mix):
    """The paper case (E = 1024, n = 10) on 132 SMs: every block on the card
    at once, each owning ceil(E / (132 x blocks an SM)) elements; fp64 K4
    stages all three of its operands at two blocks an SM (80,000 bytes,
    grid 256 x 4), fp64 K3 its metric alone (96,000 bytes: p, the metric
    and the mask of an element are 64 KB, two stages of them leave one
    block an SM); the 4-byte builds run four blocks an SM."""
    for kernel in ("k4", "k3"):
        plan, _, _ = _plan(kernel, 1024, 10, mix)
        assert plan.grid <= SMS * plan.blocks_per_sm
        assert plan.per_block == -(-1024 // (SMS * plan.blocks_per_sm))
        assert plan.grid == -(-1024 // plan.per_block)
        assert plan.blocks_per_sm == (2 if mix == "f64" else 4)
        assert plan.bulk
    if mix == "f64":
        k4, _, _ = _plan("k4", 1024, 10, mix)
        assert (k4.staged, k4.smem_bytes, k4.grid, k4.per_block) == (
            ("p_prev", "r", "g3"), 80000, 256, 4)
        k3, _, _ = _plan("k3", 1024, 10, mix)
        assert (k3.staged, k3.smem_bytes) == (("g",), 96000)


def test_walk_plan_raises_where_no_ring_fits():
    for kernel in ("k4", "k3"):
        planner, operands = PLANNERS[kernel]
        with pytest.raises(ValueError, match="no ring"):
            planner(1024, 10, "f64", SMS, lambda dyn: 0, SMEM_PER_BLOCK)
        # not even the smallest operand's two stages fit a block
        least = min(K.walk_slot_bytes(b, True)
                    for b in operands(16, "f64").values())
        with pytest.raises(ValueError, match="n=16, f64"):
            planner(1024, 16, "f64", SMS, lambda dyn: 4, 2 * least - 1)
        for bad in (dict(E=0), dict(sm_count=0)):
            kw = dict(E=1024, sm_count=SMS) | bad
            with pytest.raises(ValueError):
                planner(kw["E"], 10, "f64", kw["sm_count"], lambda dyn: 2,
                        SMEM_PER_BLOCK)


def test_walk_plan_launch_ints():
    plan, _, _ = _plan("k4", 1024, 10, "f64")
    assert plan.staged_mask == 0b111
    assert plan.launch_ints == (plan.per_block, plan.grid, K.STAGES, 7, 1)
    k3, _, _ = _plan("k3", 1024, 10, "f64")
    assert k3.staged_mask == 0b010 and k3.launch_ints[3:] == (2, 1)


# ---------------------------------------------------------------------------
# The planner's constants are the sources'
# ---------------------------------------------------------------------------
def test_walk_constants_are_the_sources():
    common = (CSRC / "common.cuh").read_text()
    most = int(re.search(r"constexpr int kMaxStages = (\d+);",
                         common).group(1))
    assert 2 <= K.STAGES <= most
    # kWalkMinBlocks: the threads an SM the register cap is set for
    assert "(sizeof(A) == 8 ? 256 : 512) / ((N * N + 31) / 32 * 32)" in common
    # walk_slot_bytes: bulk the bytes, cp.async rounded to 16 plus 16
    assert "return bulk ? bytes : (bytes + 15) / 16 * 16 + 16;" in common
    for nbytes in (16, 200, 216, 1000, 8000):
        assert K.walk_slot_bytes(nbytes, True) == nbytes
        assert K.walk_slot_bytes(nbytes, False) == \
            (nbytes + 15) // 16 * 16 + 16
    slab = (CSRC / "nekbone_ax_slab.cu").read_text()
    assert "const void* const src[3] = {a.p_prev, a.r, a.g3};" in slab
    assert K.k4_operands(10, "f64") == {"p_prev": 8000, "r": 8000,
                                        "g3": 24000}
    dots = (CSRC / "nekbone_ax_dots.cu").read_text()
    assert "const void* const src[3] = {a.p, a.g, a.mask};" in dots
    assert K.k3_operands(10, "bf16_ir") == {"p": 2000, "g": 24000,
                                            "mask": 2000}
    # the launches are no longer one block per element
    for src in (slab, dots):
        assert "<<<E, dim3(N, N)" not in src
        assert "<<<grid, dim3(N, N), dyn, stream>>>" in src


# ---------------------------------------------------------------------------
# The wrappers on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,grid", [(4, (2, 2, 2)), (3, (3, 3, 5))])
def test_k4_k3_k2_wrappers_on_cpu_are_the_plain_versions(n, grid):
    rng = np.random.default_rng(20)
    case = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    E, n3 = case.mesh.nelt, n ** 3
    (mx, my, mz), _ = ops.slab_axis_factors(grid, n, torch.float64, "cpu")
    g3 = ops.diag_metric(case.g, E, n)
    p2 = torch.as_tensor(rng.normal(size=(E, n3)))
    r2 = torch.as_tensor(rng.normal(size=(E, n3)))
    beta = torch.tensor(0.37, dtype=torch.float64)
    got = K.nekbone_ax_slab_cuda(p2, r2, case.D, g3, mx, my, mz, beta, n=n)
    want = K.nekbone_ax_slab_plain(p2, r2, case.D, g3, mx, my, mz, beta, n=n)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    g2 = case.g.reshape(E, 6, n3)
    mask = case.mask.reshape(E, n3)
    c = case.c.reshape(E, n3)
    got = K.nekbone_ax_pap_cuda(p2, case.D, g2, mask, n=n)
    want = K.nekbone_ax_pap_plain(p2, case.D, g2, mask, n=n)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = K.nekbone_ax_dots_cuda(p2, case.D, g2, mask, r2, c, n=n)
    want = K.nekbone_ax_dots_plain(p2, case.D, g2, mask, r2, c, n=n)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
