"""The designs of K11 (one cooperative launch) and K14 (column tiles and row
groups per head), on the CPU.

* ``kernels.nekbone_ax.k11_plan``: every element is owned by exactly one
  block, in contiguous z-major ranges; the shared-memory variant is chosen
  if and only if the owned state fits (checked against a direct search
  over every owned count); a size neither variant can run raises.  The
  occupancy of a block comes from an argument (on the card, CUDA's
  occupancy calculator); here from a model of the H100's limits.
* ``kernels.ref.wkv6_split_emulated``, K14's grouping of the sums in torch,
  against the JAX package's ``wkv6`` (the sequential body, in interpret
  mode) and ``ref.wkv6_ref``, float32, to 1e-5 of the largest value (two
  float32 orders of the same sums over up to 48 steps).
* The tilings the wrapper launches are the ones the CUDA source builds.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import wkv6 as jwkv6
from repro_torch.kernels import nekbone_ax as K
from repro_torch.kernels import ref, wkv6

F32_TOL = 1e-5
CSRC = pathlib.Path(K.__file__).with_name("csrc")

# The H100's limits as the occupancy calculator applies them: 228 KB of
# shared memory an SM, 1 KB of it reserved for each block, 65536 registers
# and at most 32 blocks an SM; a block's threads take registers in whole
# warps.
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
SMS = 132


def occupancy(threads, registers, static_smem):
    """blocks_per_sm(resident, dyn) of a kernel with these resources."""
    warps = -(-threads // 32)

    def blocks_per_sm(resident, dyn):
        if static_smem + dyn > SMEM_PER_BLOCK:
            return 0
        return min(32, 65536 // (registers * 32 * warps),
                   SMEM_PER_SM // (static_smem + dyn + 1024))
    return blocks_per_sm


# (n, dtype, threads, registers, static shared bytes, slices): K11's blocks
# as built (n x n x slices threads; AxShared and the block sum per slice)
BLOCKS = {
    (10, torch.float64): (400, 72, 19200, 4),
    (10, torch.float32): (400, 72, 9600, 4),
    (5, torch.float64): (200, 64, 7200, 8),
    (3, torch.float64): (144, 56, 6912, 16),
    (16, torch.float64): (512, 128, 24576, 2),
}


def _plan(E, n, dtype, sm_count=SMS):
    threads, regs, static, slices = BLOCKS[(n, dtype)]
    fit = occupancy(threads, regs, static)
    plan = K.k11_plan(E, n, dtype, sm_count, fit, SMEM_PER_BLOCK - static,
                      slices=slices)
    return plan, fit, static, slices


CASES = [(E, n, dtype) for E in (1, 7, 64, 1024, 1500, 4096, 20000)
         for n, dtype in BLOCKS]


@pytest.mark.parametrize("E,n,dtype", CASES)
def test_k11_plan_covers_every_element_once(E, n, dtype):
    plan, _, _, slices = _plan(E, n, dtype)
    m = plan.per_block   # block b owns [b m, (b + 1) m), cut at E
    ranges = [(b * m, min((b + 1) * m, E)) for b in range(plan.grid)]
    assert len(ranges) == plan.grid
    assert ranges[0][0] == 0 and ranges[-1][1] == E
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c                      # contiguous, no gap, no overlap
    assert all(a < b for a, b in ranges)   # every block owns an element
    assert sum(b - a for a, b in ranges) == E
    assert plan.per_block % slices == 0
    assert all(b - a <= plan.per_block for a, b in ranges)


@pytest.mark.parametrize("E,n,dtype", CASES)
def test_k11_plan_shared_iff_the_state_fits(E, n, dtype):
    plan, fit, static, slices = _plan(E, n, dtype)
    state = K.k11_state_bytes(n, dtype)
    fitting = [m for m in range(slices, E + slices, slices)
               if m * state <= SMEM_PER_BLOCK - static
               and fit(True, m * state) >= 1
               and -(-E // m) <= SMS * fit(True, m * state)]
    assert plan.resident == bool(fitting)
    if plan.resident:
        assert plan.per_block == fitting[0]
        assert plan.smem_bytes == plan.per_block * state
    else:
        assert plan.smem_bytes == slices * n ** 3 * dtype.itemsize
    # every block of the grid is resident at once
    assert plan.grid <= SMS * plan.blocks_per_sm
    assert plan.blocks_per_sm == fit(plan.resident, plan.smem_bytes)


def test_k11_plan_paper_case():
    """The paper case keeps its state in shared memory (four elements a
    block, two blocks an SM); the 16x16x16 grid does not fit and keeps it in
    device memory."""
    plan, *_ = _plan(1024, 10, torch.float64)
    assert (plan.variant, plan.per_block, plan.grid, plan.blocks_per_sm) \
        == ("shared", 4, 256, 2)
    plan, *_ = _plan(4096, 10, torch.float64)
    assert plan.variant == "device" and plan.grid <= 2 * SMS


def test_k11_plan_raises_where_neither_variant_runs():
    state = K.k11_state_bytes(10, torch.float64)
    # no block of either variant is resident (registers or threads)
    with pytest.raises(ValueError, match="either variant"):
        K.k11_plan(1024, 10, torch.float64, SMS, lambda res, dyn: 0,
                   SMEM_PER_BLOCK)
    # the state does not fit and neither does the device variant's column
    with pytest.raises(ValueError, match="either variant"):
        K.k11_plan(1024, 10, torch.float64, SMS, lambda res, dyn: 4,
                   state - 1, slices=4)
    for bad in (dict(E=0), dict(sm_count=0), dict(slices=0)):
        kw = dict(E=1024, sm_count=SMS, slices=4) | bad
        with pytest.raises(ValueError):
            K.k11_plan(kw["E"], 10, torch.float64, kw["sm_count"],
                       lambda res, dyn: 2, SMEM_PER_BLOCK,
                       slices=kw["slices"])


# ---------------------------------------------------------------------------
# K14
# ---------------------------------------------------------------------------
def _wkv_data(rng, B, H, T, d):
    return (rng.normal(size=(B, H, T, d)), rng.normal(size=(B, H, T, d)),
            rng.normal(size=(B, H, T, d)),
            np.exp(-np.exp(rng.uniform(-8.0, 1.0, size=(B, H, T, d)))),
            rng.normal(size=(H, d)))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("d,col_tile,row_groups",
                         [(16, 16, 4), (16, 16, 8), (16, 8, 2), (16, 4, 16),
                          (64, 32, 8), (64, 32, 16), (64, 16, 8),
                          (64, 64, 1)])
@pytest.mark.parametrize("T", [1, 37, 48])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_wkv6_split_emulated_matches_reference(d, col_tile, row_groups, T,
                                               with_state):
    rng = np.random.default_rng(18)
    B, H = 2, 2
    arrays = _wkv_data(rng, B, H, T, d)
    s0 = rng.normal(size=(B, H, d, d)) if with_state else None
    want_o, want_s = jwkv6(
        *(jnp.asarray(a, jnp.float32) for a in arrays),
        initial_state=None if s0 is None else jnp.asarray(s0, jnp.float32),
        return_state=True, block_t=16, variant="sequential", interpret=True)
    args = tuple(torch.tensor(np.asarray(a, np.float32)) for a in arrays)
    s0t = None if s0 is None else torch.tensor(np.asarray(s0, np.float32))
    o, s = ref.wkv6_split_emulated(*args, col_tile=col_tile,
                                   row_groups=row_groups, initial_state=s0t,
                                   return_state=True)
    assert o.dtype == torch.float32 and tuple(o.shape) == (B, H, T, d)
    assert _rel(o.numpy(), want_o) <= F32_TOL
    assert _rel(s.numpy(), want_s) <= F32_TOL
    po, ps = ref.wkv6_ref(*args, initial_state=s0t, return_state=True)
    assert _rel(o.numpy(), po.numpy()) <= F32_TOL
    assert _rel(s.numpy(), ps.numpy()) <= F32_TOL


def test_wkv6_split_emulated_rejects_a_tiling_that_does_not_divide_d():
    x = torch.zeros(1, 1, 2, 16)
    with pytest.raises(ValueError):
        ref.wkv6_split_emulated(x, x, x, x + 0.5, torch.zeros(1, 16),
                                col_tile=12, row_groups=2)


def test_k14_tilings_are_the_ones_the_source_builds():
    src = (CSRC / "wkv6.cu").read_text()
    macro = src[src.index("#define WKV6_FOR_EACH_TILING(X)"):
                src.index("template <typename T>\nint dispatch(")]
    built = {tuple(int(v) for v in m.groups())
             for m in re.finditer(r"X\((\d+), (\d+), (\d+), (\d+), (\d+)\)",
                                  macro)}
    launched = {(d, *tiles) for table in (wkv6.TILES, wkv6.DECODE_TILES)
                for d, tiles in table.items()}
    assert built == launched
    for table in (wkv6.TILES, wkv6.DECODE_TILES):
        assert set(table) == set(wkv6.HEAD_DIMS)
    for d, col_tile, groups, per_thread, steps in built:
        assert d % col_tile == 0 and d % groups == 0
        assert col_tile % per_thread == 0 and steps >= 1
    # more blocks than heads at rwkv6-1.6b's serve shape (batch 4, 32
    # heads of 64), for a prompt and for a decode step
    for table in (wkv6.TILES, wkv6.DECODE_TILES):
        assert 4 * 32 * (64 // table[64][0]) > 4 * 32


def test_wkv6_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    args = tuple(torch.tensor(np.asarray(a, np.float32))
                 for a in _wkv_data(rng, 1, 2, 5, 16))
    o, s = wkv6.wkv6_cuda(*args)
    po, ps = ref.wkv6_ref(*args, return_state=True)
    assert torch.equal(o, po) and torch.equal(s, ps)
