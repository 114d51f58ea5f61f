"""The designs of K1 and K9: persistent walkers that stage the next
element's operands in a ring in shared memory, on the CPU.

* ``kernels.nekbone_ax.k1_plan`` (u and the metric) and ``k9_plan`` (x, p,
  r and the element's basis block): every element is owned by exactly one
  block, in contiguous z-major ranges; the grid is on the card at once (one
  wave); the copy path is TMA's bulk copy exactly where every operand's
  bytes are a multiple of 16 and the pointers 16-byte aligned, per-thread
  cp.async otherwise; the dynamic shared memory is what the ring's stages
  hold: K1 residency first (f32 at n = 10 stages the metric alone), K9
  every operand wherever one block of that ring fits an SM (s = 4 in fp64:
  2 x 80,000 bytes, one block an SM), else residency first (s = 10 in
  fp64: x, p and r, the basis read from device memory); a size no ring
  fits raises.  The occupancy of a block comes from an argument (on the
  card, CUDA's occupancy calculator); here from a model of the H100's
  limits.
* The planners' constants are the CUDA sources' (the operand order, the
  C signatures, kSstepMaxK, the sweep K1 runs).
* On the CPU the K1 and K9 wrappers are their plain versions, and those
  plain versions agree with the JAX kernels in interpret mode: K1 at odd
  and even n on a random SPD metric, K9 at the cycle lengths
  tests/test_torch_sstep.py does not take (s = 3, 5, 10).
"""
import itertools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.geom import random_spd_metric
from repro.core.nekbone import NekboneCase as JaxCase
from repro.kernels import nekbone_ax as jax_kernels
from repro.kernels import ops as jax_ops
from repro_torch.kernels import _build
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


def registers(kernel, n, mix):
    """The walkers' registers a thread at their cap: as many blocks an SM
    as 256 threads (fp64; K9 384) or 512 (the 4-byte accumulation type)
    fill, at least one, at most 255 (csrc/common.cuh kWalkMinBlocks,
    csrc/nekbone_sstep_update.cu kSstepMinBlocks)."""
    threads = -(-n * n // 32) * 32
    fill = (384 if kernel == "k9" else 256) if mix == "f64" else 512
    blocks = max(1, fill // threads)
    return min(255, 65536 // (blocks * threads) // 8 * 8)


def static_smem(kernel, n, mix):
    """K1: AxVecShared (D and three layers, rows padded to an odd number of
    16-byte units) and the barriers; K9: the coefficients (kSstepMaxK rows
    of 4), block_sum_shfl's two buffers and the barriers."""
    acc = 8 if mix == "f64" else 4
    if kernel == "k1":
        pitch = (-(-n * acc // 16) | 1) * 16
        return 4 * n * pitch + 8 * 4
    return (2 * K.SSTEP_MAX_S + 1) * 4 * acc + 2 * n * n * acc + 8 * 4


def occupancy(n, regs, static):
    """blocks_per_sm(dyn) of an n x n thread block with these resources."""
    warps = -(-n * n // 32)

    def blocks_per_sm(dyn):
        if static + dyn > SMEM_PER_BLOCK:
            return 0
        return min(32, 2048 // (32 * warps), 65536 // (regs * 32 * warps),
                   SMEM_PER_SM // (static + dyn + 1024))
    return blocks_per_sm


def _plan(kernel, E, n, mix, *, s=4, aligned=True, regs=None):
    static = static_smem(kernel, n, mix)
    fit = occupancy(n, regs or registers(kernel, n, mix), static)
    if kernel == "k1":
        plan = K.k1_plan(E, n, mix, SMS, fit, SMEM_PER_BLOCK - static,
                         aligned=aligned)
        return plan, fit, static, K.k1_operands(n, mix)
    plan = K.k9_plan(E, n, mix, SMS, fit, SMEM_PER_BLOCK - static, s=s,
                     aligned=aligned)
    return plan, fit, static, K.k9_operands(n, s, mix)


ES = (1, 7, 45, 131, 133, 1024, 4096)
NS = (2, 3, 5, 10, 16)
CASES = ([("k1", E, n, mix, 0) for E, n, mix in
          itertools.product(ES, NS, K.MIXES)]
         + [("k9", E, n, mix, s) for E, n, mix, s in
            itertools.product(ES, (3, 5, 10), K.MIXES, (1, 2, 4, 10))])


@pytest.mark.parametrize("kernel,E,n,mix,s", CASES)
def test_plan_covers_every_element_once(kernel, E, n, mix, s):
    """Block b owns [b m, (b + 1) m), cut at E: contiguous z-major ranges,
    every element once, every block an element; all blocks resident at
    once."""
    plan, _, _, _ = _plan(kernel, E, n, mix, s=s)
    m = plan.per_block
    ranges = [(b * m, min((b + 1) * m, E)) for b in range(plan.grid)]
    assert ranges[0][0] == 0 and ranges[-1][1] == E
    for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
        assert hi == lo                    # contiguous, no gap, no overlap
    assert all(lo < hi for lo, hi in ranges)
    assert plan.grid <= SMS * plan.blocks_per_sm    # one wave
    assert plan.per_block == -(-E // (SMS * plan.blocks_per_sm))


@pytest.mark.parametrize("kernel,E,n,mix,s", CASES)
def test_plan_ring_and_path(kernel, E, n, mix, s):
    """The dynamic shared memory is what the ring's stages hold (never
    above a block's 232,448 bytes); the copy path is bulk exactly where
    every operand is a multiple of 16 bytes (n even); K9 stages all four
    wherever one block of their ring fits an SM, at the residency that ring
    allows, and K1 (and K9 where no such block fits) stages the largest
    set at the most blocks an SM the registers allow."""
    plan, fit, static, ops_ = _plan(kernel, E, n, mix, s=s)
    assert plan.operands == tuple(ops_)
    assert plan.bulk == (n % 2 == 0) == all(v % 16 == 0
                                            for v in ops_.values())
    assert plan.copy == ("bulk" if plan.bulk else "cp.async")
    assert plan.stages == K.STAGES >= 2
    slots = {k: K.walk_slot_bytes(v, plan.bulk) for k, v in ops_.items()}
    assert plan.smem_bytes == plan.stages * sum(slots[k] for k in plan.staged)
    assert plan.smem_bytes + static <= SMEM_PER_BLOCK
    assert plan.blocks_per_sm == fit(plan.smem_bytes) >= 1
    ring = plan.stages * sum(slots.values())
    if kernel == "k9" and fit(ring) >= 1:
        assert plan.staged == tuple(ops_)
        assert plan.blocks_per_sm == fit(ring)
    else:
        # residency first: no set stages more bytes at this residency, and
        # no set at all fits one block more
        most = max(fit(0), 1)
        assert plan.blocks_per_sm == min(fit(0), most)
        for r in range(1, len(ops_) + 1):
            for sub in itertools.combinations(ops_, r):
                dyn = plan.stages * sum(slots[k] for k in sub)
                if fit(dyn) >= plan.blocks_per_sm:
                    assert sum(ops_[k] for k in sub) <= sum(
                        ops_[k] for k in plan.staged)


@pytest.mark.parametrize("mix,regs", [
    (mix, regs) for mix in K.MIXES
    for regs in ((176, 255) if mix == "f64" else (112, 128))])
def test_k1_plan_paper_case(mix, regs):
    """n = 10, E = 1024 and 4096, at register counts that allow two blocks
    an SM in fp64 and four in the 4-byte builds: fp64 stages both operands
    (2 x 56,000 bytes); f32 the metric alone (2 x 24,000 bytes; both, 2 x
    28,000, leave no room for a fourth block beside the sweep's shared
    memory) and reads u from device memory; bf16 and bf16_ir both, 2 x
    14,000 and 2 x 26,000 bytes; TMA bulk copies."""
    for E in (1024, 4096):
        plan, fit, _, _ = _plan("k1", E, 10, mix, regs=regs)
        assert plan.bulk and plan.grid <= SMS * plan.blocks_per_sm
        if mix == "f64":
            assert plan.staged == ("u", "g") and plan.smem_bytes == 112000
            assert plan.blocks_per_sm == 2 and plan.grid == 256
        elif mix == "f32":
            assert plan.staged == ("g",) and plan.smem_bytes == 48000
        else:
            assert plan.staged == ("u", "g")
            assert plan.smem_bytes == {"bf16": 28000,
                                       "bf16_ir": 52000}[mix]
        if mix != "f64":
            assert plan.blocks_per_sm == 4 and plan.grid == 512


@pytest.mark.parametrize("mix", tuple(K.MIXES))
def test_k9_plan_paper_case(mix):
    """n = 10, E = 1024: at s = 4 every operand staged (fp64 2 x 80,000
    bytes, one block an SM; f32 2 x 40,000 at two; bf16 2 x 20,000 and
    bf16_ir 2 x 22,000 at four); at s = 10 in fp64 no ring holds the
    basis (152,000 bytes an element): x, p and r are staged at three blocks
    an SM (K9's register cap), the basis is read from device memory."""
    plan, _, _, ops_ = _plan("k9", 1024, 10, mix, s=4)
    assert plan.bulk and plan.staged == ("x", "p", "r", "basis")
    assert plan.smem_bytes == 2 * sum(ops_.values()) == {
        "f64": 160000, "f32": 80000, "bf16": 40000, "bf16_ir": 44000}[mix]
    assert plan.blocks_per_sm == {"f64": 1, "f32": 2, "bf16": 4,
                                  "bf16_ir": 4}[mix]
    assert plan.grid == -(-1024 // plan.per_block)
    if mix == "f64":
        assert K.k9_operands(10, 10, mix)["basis"] == 152000
        big, _, _, _ = _plan("k9", 1024, 10, mix, s=10)
        assert big.staged == ("x", "p", "r") and big.smem_bytes == 48000
        assert big.blocks_per_sm == 3


@pytest.mark.parametrize("kernel,n,mix", itertools.product(
    ("k1", "k9"), (2, 3, 4, 5, 10, 11, 16), tuple(K.MIXES)))
def test_plan_bulk_only_where_aligned(kernel, n, mix):
    """A pointer off 16-byte alignment takes the cp.async path at any n,
    with the margin of its copy window in every slot; aligned, the bulk
    path exactly at even n."""
    plan, _, _, ops_ = _plan(kernel, 1024, n, mix, aligned=False)
    assert not plan.bulk and plan.copy == "cp.async"
    for k in plan.staged:
        slot = K.walk_slot_bytes(ops_[k], False)
        assert slot % 16 == 0 and slot >= ops_[k] + 16
    aligned, _, _, _ = _plan(kernel, 1024, n, mix)
    assert aligned.bulk == (n % 2 == 0)


def test_plan_raises_where_no_ring_fits():
    for planner, kw in ((K.k1_plan, {}), (K.k9_plan, dict(s=4))):
        with pytest.raises(ValueError, match="no ring"):
            planner(1024, 10, "f64", SMS, lambda dyn: 0, SMEM_PER_BLOCK,
                    **kw)
        with pytest.raises(ValueError, match="n=16"):
            planner(1024, 16, "f64", SMS, lambda dyn: 4, 1000, **kw)
        for E, sms in ((0, SMS), (1024, 0)):
            with pytest.raises(ValueError):
                planner(E, 10, "f64", sms, lambda dyn: 2, SMEM_PER_BLOCK,
                        **kw)
    for s in (0, K.SSTEP_MAX_S + 1):
        with pytest.raises(ValueError, match=f"s={s}"):
            K.k9_plan(1024, 10, "f64", SMS, lambda dyn: 2, SMEM_PER_BLOCK,
                      s=s)


def test_plans_are_the_walkers():
    assert K._WALK_PLANNERS["nekbone_ax"] is K.k1_plan
    assert K._WALK_PLANNERS["nekbone_sstep_update"] is K.k9_plan
    plan, _, _, _ = _plan("k1", 1024, 10, "f64")
    assert plan.launch_ints == (plan.per_block, plan.grid, K.STAGES, 0b11,
                                1)
    plan, _, _, _ = _plan("k9", 1024, 5, "bf16", s=2)
    assert plan.launch_ints[2:] == (K.STAGES, 0b1111, 0)


# ---------------------------------------------------------------------------
# The planners' constants are the sources'
# ---------------------------------------------------------------------------
def _entry_ints(source: str, name: str) -> int:
    """The int parameters of the C entry point ``name`` in ``source``."""
    sig = re.search(rf'extern "C" int {name}##SUFFIX\((.*?)\)',
                    source, re.S).group(1)
    return len(re.findall(r"\bint \w+", sig))


def test_k1_k9_constants_are_the_sources():
    common = (CSRC / "common.cuh").read_text()
    k1 = (CSRC / "nekbone_ax.cu").read_text()
    k9 = (CSRC / "nekbone_sstep_update.cu").read_text()
    # K1's ring: u in S, then the metric (6 n^3) in O
    assert "const void* const src[2] = {a.u, a.g};" in k1
    assert "bytes[0] = N * N * N * kS;" in k1
    assert "bytes[1] = 6 * N * N * N * kO;" in k1
    assert K.k1_operands(10, "bf16_ir") == {"u": 2000, "g": 24000}
    # K9's ring: x in X, p and r in S, the basis block (2s - 1) n^3 in S
    assert "const void* const src[4] = {a.x, a.p, a.r, a.basis};" in k9
    assert "bytes[3] = (2 * s - 1) * N * N * N * kS;" in k9
    assert K.k9_operands(10, 4, "f64") == {"x": 8000, "p": 8000, "r": 8000,
                                           "basis": 56000}
    # V's column order (K8's): p, basis[0..s-1], r, basis[s..2s-2]
    assert "m == s + 1 ? rs : bs + (m <= s ? m - 1 : m - 2) * N3" in k9
    # K9's register cap
    assert "(sizeof(A) == 8 ? 384 : 512) / ((N * N + 31) / 32 * 32)" in k9
    assert "__launch_bounds__(N * N, kSstepMinBlocks<N, A>)" in k9
    # kSstepMaxS and kSstepMaxK
    assert f"constexpr int kSstepMaxS = {K.SSTEP_MAX_S};" in common
    assert "constexpr int kSstepMaxK = 2 * kSstepMaxS + 1;" in common
    assert "for (int m = 0; m < kSstepMaxK; ++m) {\n    if (m < K) {" in k9
    # K1 runs the sweep with vector reads of the layer's rows
    assert "__shared__ __align__(16) AxVecShared<N, A> sh;" in k1
    assert "ax_columns_vec(sh, dr, metric, uc, wc, i, j);" in k1
    # persistent walkers, no launch of one block an element
    for src in (k1, k9):
        assert "<<<grid, dim3(N, N), dyn, stream>>>" in src
        assert "<<<E, dim3(N, N)" not in src
        assert "asm volatile" not in src
        assert "/*any_head=*/true" in src
    # the C signatures the wrappers pass
    assert K._ARGTYPES["nekbone_ax"] == \
        [K._P] * 4 + [K._I] * _entry_ints(k1, "nekbone_ax_") + [K._P]
    assert K._ARGTYPES["nekbone_sstep_update"] == \
        [K._P] * 12 + [K._I] * _entry_ints(k9, "nekbone_sstep_update_") \
        + [K._P]
    for stem, src in (("nekbone_ax", k1), ("nekbone_sstep_update", k9)):
        assert f'extern "C" int {stem}_query_##SUFFIX(int n, int resident,' \
            in src
    # the new sweep lives after every helper the other kernels use
    assert common.index("ax_columns_vec") > common.index(
        "cg_update_walk(const UpdateArgs")


# ---------------------------------------------------------------------------
# The wrappers on the CPU, and the plain versions against the JAX kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,grid,s", [(4, (2, 2, 2), 1), (3, (3, 1, 5), 3),
                                      (5, (1, 2, 2), 10)])
def test_k1_k9_wrappers_on_cpu_are_the_plain_versions(n, grid, s):
    rng = np.random.default_rng(25)
    E, n3 = grid[0] * grid[1] * grid[2], n ** 3
    u, x, p, r = (torch.as_tensor(rng.normal(size=(E, n3)))
                  for _ in range(4))
    D = torch.as_tensor(rng.normal(size=(n, n)))
    g = torch.as_tensor(random_spd_metric(rng, E, n).reshape(E, 6, n3))
    _build.reset_launches()
    assert torch.equal(K.nekbone_ax_cuda(u, D, g, n=n),
                       K.nekbone_ax_plain(u, D, g, n=n))
    basis = torch.as_tensor(rng.normal(size=(E, 2 * s - 1, n3)))
    coef = torch.as_tensor(rng.normal(size=(3, 2 * s + 1)))
    _, c = ops.slab_axis_factors(grid, n, torch.float64, "cpu")
    got = K.nekbone_sstep_update_cuda(x, p, r, basis, coef, *c, n=n, s=s)
    want = K.nekbone_sstep_update_plain(x, p, r, basis, coef, *c, n=n, s=s)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[3].shape == (E,)
    assert _build.LAUNCHES == {name: 0 for name in _build.LAUNCHES}


@pytest.mark.parametrize("n", [4, 7])
def test_k1_plain_matches_jax_kernel(x64, n):
    """The plain K1 against ``nekbone_ax_pallas`` in interpret mode over
    two blocks of elements, on a random SPD metric: 1e-12 of the field's
    largest value (the contractions sum in another order)."""
    rng = np.random.default_rng(100 + n)
    E = 6
    g = random_spd_metric(rng, E, n).reshape(E, 6, n ** 3)
    u = rng.normal(size=(E, n ** 3))
    D = np.array(JaxCase(n=n, grid=(1, 2, 3), dtype=jnp.float64).D)
    want = np.asarray(jax_kernels.nekbone_ax_pallas(
        jnp.asarray(u), jnp.asarray(D), jnp.asarray(D.T), jnp.asarray(g),
        n=n, block_e=3, interpret=True))
    got = K.nekbone_ax_cuda(torch.as_tensor(u), torch.as_tensor(D),
                            torch.as_tensor(g), n=n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("grid,n,sz,s", [((2, 2, 2), 4, 1, 3),
                                         ((1, 2, 2), 3, 2, 5),
                                         ((2, 1, 2), 4, 1, 10)])
def test_k9_plain_matches_jax_kernel(x64, grid, n, sz, s):
    """The plain K9 against ``nekbone_sstep_update_pallas`` in interpret
    mode at s = 3, 5 and 10: x, r, p to 1e-13, the summed rcr partials to
    1e-12 (the reference suite's bars, tests/test_torch_sstep.py)."""
    rng = np.random.default_rng(200 + s)
    E, n3 = grid[0] * grid[1] * grid[2], n ** 3
    x, p, r = (rng.normal(size=(E, n3)) for _ in range(3))
    basis = rng.normal(size=(E, 2 * s - 1, n3))
    coef = rng.normal(size=(3, 2 * s + 1))
    _, (jcx, jcy, jcz) = jax_ops.slab_axis_factors(grid, n, jnp.float64)
    jx, jr, jp, jrcr = jax_kernels.nekbone_sstep_update_pallas(
        jnp.asarray(x), jnp.asarray(p), jnp.asarray(r), jnp.asarray(basis),
        jnp.asarray(coef), jcx, jcy, jcz, n=n, grid=grid, sz=sz, s=s,
        interpret=True)
    _, c = ops.slab_axis_factors(grid, n, torch.float64, "cpu")
    tx, tr, tp, trcr = K.nekbone_sstep_update_cuda(
        *(torch.as_tensor(a) for a in (x, p, r, basis, coef)), *c, n=n, s=s)
    for name, got, want in (("x", tx, jx), ("r", tr, jr), ("p", tp, jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                                   atol=1e-13, err_msg=name)
    np.testing.assert_allclose(float(trcr.sum()), float(jnp.sum(jrcr)),
                               rtol=1e-12)
