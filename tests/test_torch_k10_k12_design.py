"""The designs of K10 and K12, on the CPU.

* ``kernels.nekbone_ax.k10_plan``: K5's walker over x, p, z, w and invd.
  Every element is owned by exactly one block, in contiguous z-major
  ranges; the grid is on the card at once (one wave); the copy path is
  TMA's bulk copy exactly where every operand's bytes are a multiple of 16
  and the pointers 16-byte aligned, per-thread cp.async otherwise; all five
  operands are staged wherever one block of their ring fits an SM (n = 10:
  2 x 40,000 bytes in fp64 at two blocks an SM), else residency first; a
  size no ring fits raises.
* ``kernels.nekbone_ax.k12_plan``: the elements in groups of G, each group
  one copy, every group (and so every element) owned once, in one wave; on
  the bulk path every group's input (the last one's too) a multiple of 16
  bytes; G, up to the least count that keeps 128 threads a block busy, the
  one that keeps the most elements resident an SM; a ring of one stage;
  the cp.async path where u is off 16-byte alignment
  or no aligned group fits a block; a pair off the ladder and a ring no
  block holds raise.
* The occupancy of a block comes from an argument (on the card, CUDA's
  occupancy calculator); here from a model of the H100's limits.
* The planners' constants and the C signatures are the CUDA sources'.
* On the CPU the K10 and K12 wrappers are their plain versions, and those
  agree with the JAX kernels in interpret mode: K10 after K4 on grids with
  one element a z-slab (x and z to 1e-13, the summed partials to 1e-12),
  K12 at every ladder step of n = 3..10 (1e-14 relative).
"""
import itertools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.nekbone import NekboneCase as JaxCase
from repro.core.pmg import gll_interp_matrix as jax_gll_interp
from repro.kernels import nekbone_ax as jax_kernels
from repro.kernels import ops as jax_ops
from repro_torch.kernels import _build
from repro_torch.kernels import nekbone_ax as K
from repro_torch.kernels import ops

CSRC = pathlib.Path(K.__file__).with_name("csrc")

# The H100's limits as the occupancy calculator applies them (as in
# tests/test_torch_k1_k9_design.py): 228 KB of shared memory an SM, 1 KB of
# it reserved for each block, 65536 registers, 2048 threads and at most 32
# blocks an SM; a block's threads take registers in whole warps.
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
SMS = 132


def _fit(threads, regs, static, dyn):
    warps = -(-threads // 32)
    if static + dyn > SMEM_PER_BLOCK:
        return 0
    return min(32, 2048 // (32 * warps), 65536 // (regs * 32 * warps),
               SMEM_PER_SM // (static + dyn + 1024))


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------
def k10_registers(n, mix, per_sm=None):
    """K10's registers a thread at its cap (the walkers', common.cuh
    kWalkMinBlocks): as many blocks an SM as ``per_sm`` threads fill, 256
    (fp64) or 512 (the 4-byte accumulation type) unless given, at least
    one, at most 255."""
    threads = -(-n * n // 32) * 32
    per_sm = per_sm or (256 if mix == "f64" else 512)
    blocks = max(1, per_sm // threads)
    return min(255, 65536 // (blocks * threads) // 8 * 8)


def k10_static(n, mix):
    """block_sum2_shfl's two buffers of two partials and the barriers."""
    acc = 8 if mix == "f64" else 4
    return 4 * n * n * acc + 8 * 4


def _k10_plan(E, n, mix, *, aligned=True, regs=None):
    static = k10_static(n, mix)
    regs = regs or k10_registers(n, mix)

    def fit(dyn):
        return _fit(n * n, regs, static, dyn)
    return (K.k10_plan(E, n, mix, SMS, fit, SMEM_PER_BLOCK - static,
                       aligned=aligned), fit, static)


ES = (1, 7, 45, 131, 133, 1024, 4096)
K10_CASES = list(itertools.product(ES, (2, 3, 5, 10, 16), K.MIXES))


@pytest.mark.parametrize("E,n,mix", K10_CASES)
def test_k10_plan_covers_every_element_once(E, n, mix):
    plan, _, _ = _k10_plan(E, n, mix)
    m = plan.per_block
    ranges = [(b * m, min((b + 1) * m, E)) for b in range(plan.grid)]
    assert ranges[0][0] == 0 and ranges[-1][1] == E
    for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
        assert hi == lo
    assert all(lo < hi for lo, hi in ranges)
    assert plan.grid <= SMS * plan.blocks_per_sm
    assert plan.per_block == -(-E // (SMS * plan.blocks_per_sm))


@pytest.mark.parametrize("E,n,mix", K10_CASES)
def test_k10_plan_ring_and_path(E, n, mix):
    """The dynamic shared memory is what the ring's stages hold; bulk
    exactly at even n; all five staged wherever one block of their ring
    fits an SM, at the residency that ring allows."""
    plan, fit, static = _k10_plan(E, n, mix)
    ops_ = K.k10_operands(n, mix)
    assert plan.operands == ("x", "p", "z", "w", "invd") == tuple(ops_)
    assert plan.bulk == (n % 2 == 0) == all(v % 16 == 0
                                            for v in ops_.values())
    assert plan.stages == K.STAGES
    slots = {k: K.walk_slot_bytes(v, plan.bulk) for k, v in ops_.items()}
    assert plan.smem_bytes == plan.stages * sum(slots[k] for k in plan.staged)
    assert plan.smem_bytes + static <= SMEM_PER_BLOCK
    assert plan.blocks_per_sm == fit(plan.smem_bytes) >= 1
    ring = plan.stages * sum(slots.values())
    if fit(ring) >= 1:
        assert plan.staged == tuple(ops_)
        assert plan.blocks_per_sm == fit(ring)


@pytest.mark.parametrize("mix", tuple(K.MIXES))
def test_k10_plan_paper_case(mix):
    """n = 10: every operand staged, fp64 2 x 40,000 bytes at two blocks an
    SM, f32 2 x 20,000, bf16 2 x 10,000 and bf16_ir 2 x 14,000 at four;
    under a cap of three fp64 blocks an SM (K9's, which the compare
    script's ablation builds), the residency-first rule would keep x, p, z
    and w in fp64 (2 x 32,000) at three blocks an SM and read invd through
    L2."""
    for E in (1024, 4096):
        plan, fit, static = _k10_plan(E, 10, mix)
        assert plan.bulk and plan.staged == ("x", "p", "z", "w", "invd")
        assert plan.smem_bytes == {"f64": 80000, "f32": 40000,
                                   "bf16": 20000, "bf16_ir": 28000}[mix]
        assert plan.blocks_per_sm == (2 if mix == "f64" else 4)
        assert plan.grid == -(-E // plan.per_block)
        if mix == "f64":
            regs = k10_registers(10, mix, per_sm=384)
            alt = K.walk_plan("residency", E, K.k10_operands(10, mix), SMS,
                              lambda dyn: _fit(100, regs, static, dyn),
                              SMEM_PER_BLOCK - static)
            assert alt.staged == ("x", "p", "z", "w")
            assert alt.smem_bytes == 64000 and alt.blocks_per_sm == 3


@pytest.mark.parametrize("n,mix", itertools.product((2, 3, 5, 10, 11, 16),
                                                    tuple(K.MIXES)))
def test_k10_plan_bulk_only_where_aligned(n, mix):
    plan, _, _ = _k10_plan(1024, n, mix, aligned=False)
    assert not plan.bulk and plan.copy == "cp.async"
    for k in plan.staged:
        slot = K.walk_slot_bytes(K.k10_operands(n, mix)[k], False)
        assert slot % 16 == 0 and slot >= K.k10_operands(n, mix)[k] + 16


def test_k10_plan_raises_where_no_ring_fits():
    with pytest.raises(ValueError, match="no ring"):
        K.k10_plan(1024, 10, "f64", SMS, lambda dyn: 0, SMEM_PER_BLOCK)
    with pytest.raises(ValueError, match="n=16"):
        K.k10_plan(1024, 16, "f64", SMS, lambda dyn: 4, 1000)
    for E, sms in ((0, SMS), (1024, 0)):
        with pytest.raises(ValueError):
            K.k10_plan(E, 10, "f64", sms, lambda dyn: 2, SMEM_PER_BLOCK)


def test_k10_plan_is_the_walkers_and_launch_ints():
    assert K._WALK_PLANNERS["nekbone_pcg_update"] is K.k10_plan
    plan, _, _ = _k10_plan(1024, 10, "f64")
    assert plan.launch_ints == (plan.per_block, plan.grid, K.STAGES,
                                0b11111, 1)
    plan, _, _ = _k10_plan(1024, 5, "bf16")
    assert plan.launch_ints[2:] == (K.STAGES, plan.staged_mask, 0)


# ---------------------------------------------------------------------------
# K12
# ---------------------------------------------------------------------------
def k12_fit(nin, nout, mix):
    """blocks_per_sm(threads, dyn) of K12 at its register cap (65536 over
    its most threads a block) with mt and the barriers static."""
    regs = min(255, 65536 // K.k12_max_threads(nin, mix) // 8 * 8)
    static = nin * nout * K.MIXES[mix]["A"].itemsize + 8 * 4

    def fit(threads, dyn):
        return _fit(threads, regs, static, dyn)
    return fit, static


def _k12_plan(E, nin, nout, mix, **kw):
    fit, static = k12_fit(nin, nout, mix)
    return K.k12_plan(E, nin, nout, mix, SMS, fit, SMEM_PER_BLOCK - static,
                      **kw), fit


PAIRS = sorted(K.INTERP_PAIRS)
K12_CASES = list(itertools.product((1, 7, 45, 1024, 4096), PAIRS, K.MIXES))


@pytest.mark.parametrize("E,pair,mix", K12_CASES)
def test_k12_plan_covers_every_group_once(E, pair, mix):
    """Block b owns groups [b m, (b + 1) m), cut at the group count; group
    g holds elements [g G, (g + 1) G), cut at E: every element once, every
    block a group, all blocks resident at once."""
    nin, nout = pair
    plan, fit = _k12_plan(E, nin, nout, mix)
    G, m = plan.group, plan.per_block
    assert plan.groups == -(-E // G)
    ranges = [(b * m, min((b + 1) * m, plan.groups))
              for b in range(plan.grid)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.groups
    assert all(lo < hi for lo, hi in ranges)
    for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
        assert hi == lo
    owned = sorted(e for lo, hi in ranges for g in range(lo, hi)
                   for e in range(g * G, min((g + 1) * G, E)))
    assert owned == list(range(E))
    assert plan.grid <= SMS * plan.blocks_per_sm
    assert plan.blocks_per_sm == fit(plan.threads, plan.smem_bytes) >= 1
    assert plan.per_block == -(-plan.groups // (SMS * plan.blocks_per_sm))


def _k12_candidates(E, nin, nout, mix, bulk):
    """The group counts k12_plan weighs: multiples of the copy alignment
    (1 off the bulk path) up to the least that keeps K12_MIN_THREADS
    threads busy, within the most threads a block, and on the bulk path
    with a last group that is a multiple of the alignment too."""
    align = K.k12_group_align(nin, mix) if bulk else 1
    per, most = K.k12_lanes(nin, nout), K.k12_max_threads(nin, mix)
    top = align * max(1, -(-K.K12_MIN_THREADS // (align * per)))
    while top > align and top * per > most:
        top -= align
    return [g for g in range(align, top + 1, align)
            if not bulk or (E - (-(-E // g) - 1) * g) % align == 0]


@pytest.mark.parametrize("E,pair,mix", K12_CASES)
def test_k12_plan_group_and_path(E, pair, mix):
    """G nout max(nin, nout) threads within the kernel's most; the bulk path
    exactly where the least aligned group that keeps 128 threads busy, and
    its last group, are whole multiples of the copy alignment; among the
    weighed counts G keeps the most elements resident an SM (ties: the
    larger); the shared memory is the ring's one stage and the group's
    contraction along i."""
    nin, nout = pair
    plan, fit = _k12_plan(E, nin, nout, mix)
    s, a = K.MIXES[mix]["S"].itemsize, K.MIXES[mix]["A"].itemsize
    per = K.k12_lanes(nin, nout)
    assert plan.threads == plan.group * per <= K.k12_max_threads(nin, mix)
    align = K.k12_group_align(nin, mix)
    assert (align * nin ** 3 * s) % 16 == 0
    assert all((g * nin ** 3 * s) % 16 for g in range(1, align))
    least = _k12_candidates(E, nin, nout, mix, True)
    assert plan.bulk == (bool(least) and least[-1] * per
                         <= K.k12_max_threads(nin, mix)
                         and (E - (-(-E // least[-1]) - 1) * least[-1])
                         % align == 0)
    if plan.bulk:
        tail = E - (plan.groups - 1) * plan.group
        assert (plan.group * nin ** 3 * s) % 16 == 0
        assert (tail * nin ** 3 * s) % 16 == 0
    cands = _k12_candidates(E, nin, nout, mix, plan.bulk)
    assert plan.group in cands

    def blocks(g):
        return fit(g * per, K.k12_dyn_bytes(nin, nout, mix, g, plan.bulk))
    best = blocks(plan.group) * plan.group
    assert all(blocks(g) * g < best
               or (blocks(g) * g == best and g <= plan.group)
               for g in cands)
    assert plan.blocks_per_sm == blocks(plan.group)
    slot = K.walk_slot_bytes(plan.group * nin ** 3 * s, plan.bulk)
    assert K.K12_STAGES == 1
    assert plan.smem_bytes == K.k12_dyn_bytes(
        nin, nout, mix, plan.group, plan.bulk) \
        == slot + plan.group * nin * nin * nout * a


@pytest.mark.parametrize("mix", tuple(K.MIXES))
def test_k12_plan_paper_ladder(mix):
    """The paper's ladder (10 -> 5 -> 3 -> 2 and back) at E = 1024 and
    4096: every step by bulk copies, blocks of at most 128 threads' worth of
    groups."""
    for E in (1024, 4096):
        for nin, nout in ((10, 5), (5, 10), (5, 3), (3, 5), (3, 2), (2, 3)):
            plan, _ = _k12_plan(E, nin, nout, mix)
            assert plan.bulk, (nin, nout, E, plan)
            assert plan.grid <= SMS * plan.blocks_per_sm
            assert (plan.group - K.k12_group_align(nin, mix)) \
                * K.k12_lanes(nin, nout) < K.K12_MIN_THREADS


@pytest.mark.parametrize("pair,mix", itertools.product(PAIRS,
                                                       tuple(K.MIXES)))
def test_k12_plan_bulk_only_where_aligned(pair, mix):
    nin, nout = pair
    plan, _ = _k12_plan(1024, nin, nout, mix, aligned=False)
    assert not plan.bulk and plan.copy == "cp.async"
    assert plan.group in _k12_candidates(1024, nin, nout, mix, False)
    s = K.MIXES[mix]["S"].itemsize
    slot = K.walk_slot_bytes(plan.group * nin ** 3 * s, False)
    assert slot % 16 == 0 and slot >= plan.group * nin ** 3 * s + 16


def test_k12_plan_takes_cp_async_where_no_group_fits():
    """bf16 7 -> 13: a bulk copy needs 8 elements a group (13^2 threads
    each), more than a block's 1024 threads; E = 7 at fp64 5 -> 10: the
    last group of two holds one element (1,000 bytes)."""
    assert K.k12_lanes(10, 5) == 50 and K.k12_lanes(5, 10) == 100
    plan, _ = _k12_plan(1024, 7, 13, "bf16")
    assert K.k12_group_align(7, "bf16") == 8 and not plan.bulk
    assert plan.group == 1 and plan.threads == 169
    plan, _ = _k12_plan(7, 5, 10, "f64")
    assert not plan.bulk
    plan, _ = _k12_plan(8, 5, 10, "f64")
    assert plan.bulk and plan.group == 2


def test_k12_plan_raises():
    with pytest.raises(ValueError, match="ladder"):
        K.k12_plan(1024, 10, 4, "f64", SMS, lambda t, d: 2, SMEM_PER_BLOCK)
    with pytest.raises(ValueError, match="fits an SM"):
        K.k12_plan(1024, 10, 5, "f64", SMS, lambda t, d: 0, SMEM_PER_BLOCK)
    with pytest.raises(ValueError, match="fits an SM"):
        K.k12_plan(1024, 16, 8, "f64", SMS, lambda t, d: 4, 1000)
    for E, sms in ((0, SMS), (1024, 0)):
        with pytest.raises(ValueError):
            K.k12_plan(E, 10, 5, "f64", sms, lambda t, d: 2, SMEM_PER_BLOCK)


def test_k12_plan_options_and_launch_ints(monkeypatch):
    """The planner's thread floor is the module's K12_MIN_THREADS, read at
    each call (a block that walks several groups and one that takes a
    single group alike: the ring is one stage); the C entry's ints."""
    big, _ = _k12_plan(4096, 5, 10, "bf16")
    assert big.per_block > 1 and big.group == 8
    small, _ = _k12_plan(1024, 3, 2, "f64")
    assert small.per_block == 1
    monkeypatch.setattr(K, "K12_MIN_THREADS", 1)
    low, _ = _k12_plan(1024, 5, 3, "f64")
    assert low.group == K.k12_group_align(5, "f64") == 2
    assert big.launch_ints == (8, big.per_block, big.grid, 1)


# ---------------------------------------------------------------------------
# The planners' constants are the sources'
# ---------------------------------------------------------------------------
def _entry_ints(source: str, name: str) -> int:
    sig = re.search(rf'extern "C" int {name}##SUFFIX\((.*?)\)',
                    source, re.S).group(1)
    return len(re.findall(r"\bint \w+", sig))


def test_k10_k12_constants_are_the_sources():
    common = (CSRC / "common.cuh").read_text()
    k10 = (CSRC / "nekbone_pcg_update.cu").read_text()
    k12 = (CSRC / "nekbone_interp.cu").read_text()
    # K10's ring: x in X, p, z and w in S, invd in O
    assert "const void* const src[5] = {a.x, a.p, a.z, a.w, a.invd};" in k10
    assert "bytes[1] = bytes[2] = bytes[3] = N * N * N * kS;" in k10
    assert "bytes[4] = N * N * N * kO;" in k10
    assert K.k10_operands(10, "bf16_ir") == {"x": 4000, "p": 2000,
                                             "z": 2000, "w": 2000,
                                             "invd": 4000}
    # the walkers' register cap, its compile-time walk, both partials at
    # once
    assert "(sizeof(A) == 8 ? 256 : 512) / ((N * N + 31) / 32 * 32)" \
        in common
    assert "__launch_bounds__(N * N, kWalkMinBlocks<N, A>)" in k10
    assert "a.plan.bulk && a.plan.staged == 31" in k10
    assert "block_sum2_shfl<N2>(part_rtz, part_rcr, red, tid);" in k10
    assert "__shared__ A red[4 * N * N];" in k10
    assert "/*any_head=*/true" in k10
    # the arithmetic of the one-block-per-element kernel
    assert "const A d = rcp_rn(id);" in k10
    assert "const A t = mul_rn(mul_rn(mul_rn(zn, c), zn), d);" in k10
    assert "part_rcr += mul_rn(t, d);" in k10
    # K12: the ring's depth, the most threads, the shared bytes, the rows
    assert f"constexpr int kInterpStages = {K.K12_STAGES};" in k12
    assert "NIN * static_cast<int>(sizeof(A)) <= 20 ? 1024 : 256" in k12
    assert "NOUT * (NIN > NOUT ? NIN : NOUT)" in k12
    assert "__launch_bounds__(kInterpMaxThreads<NIN, A>)" in k12
    assert "group * NIN * NIN * NOUT * static_cast<int>(sizeof(A))" in k12
    assert "const WalkPlan plan{a.per_block, kInterpStages, 1, " \
        "kBulk ? 1 : 0};" in k12
    assert "constexpr int kRows = (NIN2 + kSlots - 1) / kSlots;" in k12
    assert "interp_row<NIN>(in + row * NIN, uv);" in k12
    assert "WalkRing<1> ring(full, ring_bytes, plan, src, bytes, size);" \
        in k12
    # the order kept: i, then j, then k, each over l in order
    assert k12.index("along i, every layer") \
        < k12.index("along j, every layer") < k12.index("along k, in")
    # persistent walkers, no launch of one block an element
    assert "<<<grid, dim3(N, N), dyn, stream>>>" in k10
    assert "<<<E, dim3(N, N)" not in k10
    assert "<<<grid, a.group * kInterpLanes<NIN, NOUT>, dyn, stream>>>" \
        in k12
    # the C signatures the wrappers pass
    assert K._ARGTYPES["nekbone_pcg_update"] == \
        [K._P] * 13 + [K._I] * _entry_ints(k10, "nekbone_pcg_update_") \
        + [K._P]
    assert K._ARGTYPES["nekbone_interp"] == \
        [K._P] * 3 + [K._I] * _entry_ints(k12, "nekbone_interp_") + [K._P]
    assert 'extern "C" int nekbone_pcg_update_query_##SUFFIX(int n, ' \
        'int resident,' in k10
    assert 'extern "C" int nekbone_interp_query_##SUFFIX(int nin, int nout,' \
        in k12
    assert 'extern "C" int nekbone_interp_floor_##SUFFIX(int grid, ' \
        'int threads,' in k12
    # the ladder pairs are the instantiated ones
    assert "PAIR(3) PAIR(4) PAIR(5) PAIR(6) PAIR(7) PAIR(8) PAIR(9) " \
        "PAIR(10)" in k12
    assert "PAIR(11) PAIR(12) PAIR(13) PAIR(14) PAIR(15) PAIR(16)" in k12
    # the new helper lives after every helper the other kernels use
    assert common.index("block_sum2_shfl") > common.index(
        "block_sum_shfl(T v")


# ---------------------------------------------------------------------------
# The wrappers on the CPU, and the plain versions against the JAX kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,grid", [(4, (2, 2, 2)), (3, (3, 1, 5))])
def test_k10_k12_wrappers_on_cpu_are_the_plain_versions(n, grid):
    rng = np.random.default_rng(26)
    E, n3 = grid[0] * grid[1] * grid[2], n ** 3
    x, p, z, w = (torch.as_tensor(rng.normal(size=(E, n3)))
                  for _ in range(4))
    invd = torch.as_tensor(rng.uniform(0.5, 2.0, size=(E, n3)))
    alpha = torch.tensor(0.37, dtype=torch.float64)
    _, c = ops.slab_axis_factors(grid, n, torch.float64, "cpu")
    _build.reset_launches()
    got = K.nekbone_pcg_update_cuda(x, p, z, w, alpha, invd, *c, n=n)
    want = K.nekbone_pcg_update_plain(x, p, z, w, alpha, invd, *c, n=n)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[2].shape == got[3].shape == (E,)
    nout = (n + 1) // 2
    mt = torch.as_tensor(rng.normal(size=(n, nout)))
    assert torch.equal(K.nekbone_interp_cuda(x, mt, nin=n, nout=nout),
                       K.nekbone_interp_plain(x, mt, nin=n, nout=nout))
    assert _build.LAUNCHES == {name: 0 for name in _build.LAUNCHES}


@pytest.mark.parametrize("n,E", [(5, 4), (4, 3), (6, 2)])
def test_k10_plain_matches_jax_kernel(x64, n, E):
    """K4 then K10 in fp64 on a grid of one element a z-slab (sz = 1), so
    that the reference's w is unassembled like the port's: x and z to
    1e-13, the summed rtz and rcr partials to 1e-12."""
    grid = (1, 1, E)
    n3 = n ** 3
    rng = np.random.default_rng(260 + n)
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    p_prev = jnp.asarray(rng.normal(size=(E, n3)))
    z = jnp.asarray(rng.normal(size=(E, n3)))
    x = jnp.asarray(rng.normal(size=(E, n3)))
    invd = jnp.asarray(rng.uniform(0.5, 2.0, size=(E, n3)))
    D = jcase.D
    g3 = jax_ops.diag_metric(jcase.g, E, n)
    (mx, my, mz), (cx, cy, cz) = jax_ops.slab_axis_factors(grid, n,
                                                           jnp.float64)
    beta, alpha = 0.61, 0.37
    jp, jw, bot, top, _ = jax_kernels.nekbone_ax_slab_pallas(
        p_prev, z, D, D.T, g3, mx, my, mz,
        jnp.full((1, 1), beta, jnp.float64), n=n, grid=grid, sz=1,
        interpret=True)
    zero = jnp.zeros((1, bot.shape[1]), bot.dtype)
    addb = jnp.concatenate([zero, top[:-1]], axis=0)
    addt = jnp.concatenate([bot[1:], zero], axis=0)
    jx, jz, jrtz, jrcr = jax_kernels.nekbone_pcg_update_pallas(
        x, jp, z, jw, addb, addt, jnp.full((1, 1), alpha, jnp.float64),
        invd, cx, cy, cz, n=n, grid=grid, sz=1, interpret=True)
    _, c = ops.slab_axis_factors(grid, n, torch.float64, "cpu")
    tx, tz, trtz, trcr = K.nekbone_pcg_update_cuda(
        *(torch.as_tensor(np.array(a)) for a in (x, jp, z, jw)),
        torch.tensor(alpha, dtype=torch.float64),
        torch.as_tensor(np.array(invd)), *c, n=n)
    for name, got, want in (("x", tx, jx), ("z", tz, jz)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-13, atol=1e-13, err_msg=name)
    for name, got, want in (("rtz", trtz, jrtz), ("rcr", trcr, jrcr)):
        np.testing.assert_allclose(float(got.sum()), float(jnp.sum(want)),
                                   rtol=1e-12, err_msg=name)


LADDER_3_10 = sorted({pair for nf in range(3, 11)
                      for pair in ((nf, (nf + 1) // 2), ((nf + 1) // 2, nf))})


@pytest.mark.parametrize("nin,nout", LADDER_3_10)
def test_k12_plain_matches_jax_kernel(x64, nin, nout):
    """The plain K12 against ``nekbone_interp_pallas`` in interpret mode at
    every ladder step of n = 3..10 (restriction by J, prolongation by J^T),
    fp64: 1e-14 of the field's largest value."""
    grid = (2, 1, 2)
    E = 4
    rng = np.random.default_rng(2600 + nin * 17 + nout)
    u = rng.normal(size=(E, nin ** 3))
    J = np.asarray(jax_gll_interp(max(nin, nout), min(nin, nout)))
    mt = J if nin > nout else J.T
    want = np.asarray(jax_kernels.nekbone_interp_pallas(
        jnp.asarray(u), jnp.asarray(mt), nin=nin, nout=nout, grid=grid,
        sz=1, interpret=True))
    got = K.nekbone_interp_cuda(torch.as_tensor(u), torch.as_tensor(mt),
                                nin=nin, nout=nout)
    assert got.shape == (E, nout ** 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-14 * np.abs(want).max())
