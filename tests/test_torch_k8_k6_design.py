"""The designs of K8 (one cooperative launch per s-step cycle) and K6 (lanes
in pairs through one layer sweep), on the CPU.

* ``kernels.nekbone_ax.k8_plan``: every element is owned by exactly one
  block, in contiguous z-major ranges; each block owns the least count that
  puts every block on the card at once (checked against a direct search
  over every owned count); a size no block can run raises.  The occupancy
  of a block comes from an argument (on the card, CUDA's occupancy
  calculator); here from a model of the H100's limits.  K11's own plan
  tests (tests/test_torch_k11_k14_design.py) hold its planner, whose
  device-memory variant is K8's ``device_memory_plan``.
* ``kernels.ref.sstep_gram_emulated``, K8's order of the Gram's terms in
  torch, against the JAX package's ``nekbone_ax_powers`` (its Pallas kernel
  in interpret mode) and K8's plain version, fp64.
* ``kernels.nekbone_ax.k6_lane_groups``: each lane in exactly one layer
  sweep, as the CUDA source groups them (in pairs).
* On the CPU the K8 and K6 wrappers are their plain versions.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gs as jax_gs
from repro.core.nekbone import NekboneCase as JaxCase
from repro.kernels import ops as jax_ops
from repro_torch.core.nekbone import NekboneCase as TorchCase
from repro_torch.kernels import nekbone_ax as K
from repro_torch.kernels import ops, ref

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


# (n, dtype): (threads, registers, static shared bytes, slices) of K8's
# blocks as built: n x n x slices threads (common.cuh kWideSlices: about 256), one
# AxShared2 (8 n^2 values) per slice, up to 128 registers
BLOCKS = {
    (10, torch.float64): (200, 128, 12800, 2),
    (10, torch.float32): (200, 128, 6400, 2),
    (5, torch.float64): (250, 128, 16000, 10),
    (4, torch.float64): (256, 128, 16384, 16),
    (16, torch.float64): (256, 128, 16384, 1),
}


def _plan(E, n, s, dtype, sm_count=SMS):
    threads, regs, static, slices = BLOCKS[(n, dtype)]
    fit = occupancy(threads, regs, static)
    plan = K.k8_plan(E, n, dtype, sm_count, fit, SMEM_PER_BLOCK - static,
                     s=s, slices=slices)
    return plan, fit, static, slices


CASES = [(E, n, s, dtype) for E in (1, 7, 64, 512, 1024, 4096, 20000)
         for (n, dtype) in BLOCKS for s in (1, 4, 10)]


@pytest.mark.parametrize("E,n,s,dtype", CASES)
def test_k8_plan_covers_every_element_once(E, n, s, dtype):
    plan, _, _, slices = _plan(E, n, s, dtype)
    m = plan.per_block   # block b owns [b m, (b + 1) m), cut at E
    ranges = [(b * m, min((b + 1) * m, E)) for b in range(plan.grid)]
    assert ranges[0][0] == 0 and ranges[-1][1] == E
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c                      # contiguous, no gap, no overlap
    assert all(a < b for a, b in ranges)   # every block owns an element
    assert sum(b - a for a, b in ranges) == E
    assert plan.per_block % slices == 0


@pytest.mark.parametrize("E,n,s,dtype", CASES)
def test_k8_plan_owns_the_least_that_fits_at_once(E, n, s, dtype):
    plan, fit, static, slices = _plan(E, n, s, dtype)
    scratch = K.k8_scratch_bytes(n, s, dtype, slices)
    assert not plan.resident and plan.variant == "device"
    assert plan.smem_bytes == scratch
    assert plan.blocks_per_sm == fit(False, scratch) >= 1
    fitting = [m for m in range(slices, E + slices, slices)
               if -(-E // m) <= SMS * fit(False, scratch)]
    assert plan.per_block == fitting[0]
    # every block of the grid is resident at once
    assert plan.grid <= SMS * plan.blocks_per_sm


def test_k8_scratch_holds_the_column_and_the_grams_staging():
    """A slice's scratch holds the two chains' operator input columns (n^3
    values each) during the steps, then the Gram's ring of staged layers of
    the 2s + 1 vectors and c (four up to s = 4, two past it; rows padded to
    n + 1), and its 3 x 3 tile sums of n^2 threads."""
    for n in K.N_RANGE:
        for s in range(1, K.SSTEP_MAX_S + 1):
            for slices in (1, 4):
                values = K.k8_scratch_bytes(n, s, torch.float64, slices) // 8
                assert values % slices == 0
                slot = values // slices
                assert slot >= 2 * n ** 3
                ring = 4 if s <= 4 else 2
                assert slot >= ring * (2 * s + 2) * n * (n + 1)
                assert slot >= 9 * n ** 2
                assert K.k8_scratch_bytes(n, s, torch.float32, slices) \
                    == 4 * values


def test_k8_runs_every_s_at_every_n():
    """Some variant of K8 runs for every built n and every s from 1 to
    SSTEP_MAX_S, in both dtypes, on the paper grid (a planner that raises
    here would leave the s-step route without its kernel)."""
    for n in K.N_RANGE:
        slices = max(1, 256 // n ** 2)
        for dtype in (torch.float64, torch.float32):
            static = 8 * n ** 2 * dtype.itemsize * slices
            fit = occupancy(n * n * slices, 128, static)
            for s in range(1, K.SSTEP_MAX_S + 1):
                plan = K.k8_plan(1024, n, dtype, SMS, fit,
                                 SMEM_PER_BLOCK - static, s=s, slices=slices)
                assert plan.grid * plan.per_block >= 1024


def test_k8_plan_paper_case():
    """The paper case, fp64 and fp32: four elements a block (two side by
    side, two rounds), two blocks an SM, grid 256; the 16x16x16 grid owns
    more a block on no more blocks."""
    for dtype in (torch.float64, torch.float32):
        plan, *_ = _plan(1024, 10, 4, dtype)
        assert (plan.per_block, plan.grid, plan.blocks_per_sm) \
            == (4, 256, 2)
    plan, *_ = _plan(4096, 10, 4, torch.float64)
    assert plan.per_block == 16 and plan.grid <= 2 * SMS


def test_k8_plan_raises_where_no_block_fits():
    scratch = K.k8_scratch_bytes(10, 4, torch.float64, 2)
    with pytest.raises(ValueError, match="resident on an SM"):
        K.k8_plan(1024, 10, torch.float64, SMS, lambda res, dyn: 0,
                  SMEM_PER_BLOCK, s=4, slices=2)
    # not even the scratch fits a block
    with pytest.raises(ValueError, match="resident on an SM"):
        K.k8_plan(1024, 10, torch.float64, SMS, lambda res, dyn: 4,
                  scratch - 1, s=4, slices=2)
    for bad in (dict(E=0), dict(sm_count=0), dict(slices=0)):
        kw = dict(E=1024, sm_count=SMS, slices=2) | bad
        with pytest.raises(ValueError):
            K.k8_plan(kw["E"], 10, torch.float64, kw["sm_count"],
                      lambda res, dyn: 2, SMEM_PER_BLOCK, s=4,
                      slices=kw["slices"])


def test_k8_and_k11_share_the_device_memory_plan():
    """K8's plan, and K11's where its state does not fit, are
    ``device_memory_plan`` of their own shared bytes: K8 its scratch, K11
    one n^3 column per slice."""
    for E in (64, 1024, 4096):
        threads, regs, static, slices = 400, 72, 19200, 4   # K11, n = 10
        fit = occupancy(threads, regs, static)
        column = slices * 1000 * 8
        want = K.device_memory_plan(E, SMS, fit(False, column), slices,
                                    column)
        # a budget below one element's state: the device-memory variant
        budget = K.k11_state_bytes(10, torch.float64) * slices - 1
        assert K.k11_plan(E, 10, torch.float64, SMS, fit, budget,
                          slices=slices) == want
        plan, fit, _, slices = _plan(E, 10, 4, torch.float64)
        scratch = K.k8_scratch_bytes(10, 4, torch.float64, slices)
        assert plan == K.device_memory_plan(E, SMS, fit(False, scratch),
                                            slices, scratch)


# ---------------------------------------------------------------------------
# K8's Gram: the kernel's order of terms
# ---------------------------------------------------------------------------
def _t(a):
    return torch.as_tensor(np.array(a))


def _continuous(rng, jcase):
    u = rng.normal(size=jcase.mask.shape)
    return np.array(jax_gs.ds_sum_local(jnp.asarray(u), jcase.grid)
                    * jcase.mask)


@pytest.mark.parametrize("s", [1, 2, 4, 10])
@pytest.mark.parametrize("n,grid", [(4, (2, 2, 3)), (3, (1, 3, 2))])
def test_sstep_gram_emulated_matches_reference(x64, n, grid, s):
    """The emulated order over the JAX kernel's basis: its summed partials
    against the JAX kernel's Gram (1e-11 of the largest entry, the
    reference suite's bar), per element against the plain version (1e-12);
    symmetric."""
    rng = np.random.default_rng(41)
    jcase = JaxCase(n=n, grid=grid, dtype=jnp.float64)
    E, n3 = jcase.mesh.nelt, n ** 3
    p, r = _continuous(rng, jcase), _continuous(rng, jcase)
    theta = 2.25
    jb, jg = jax_ops.nekbone_ax_powers(
        jnp.asarray(p), jnp.asarray(r), jcase.D, jcase.g, grid, s=s,
        theta=theta, sz=1, interpret=True)
    (mx, my, mz), (cx, cy, cz) = ops.slab_axis_factors(
        grid, n, torch.float64, "cpu")
    p2, r2 = _t(p).reshape(E, n3), _t(r).reshape(E, n3)
    basis = _t(jb).reshape(E, 2 * s - 1, n3)
    em = ref.sstep_gram_emulated(p2, r2, basis, cx, cy, cz, n=n, s=s)
    K_ = 2 * s + 1
    assert em.shape == (E, K_, K_) and torch.equal(em, em.transpose(1, 2))
    jg = np.asarray(jg)
    np.testing.assert_allclose(em.sum(0).numpy(), jg, rtol=1e-11,
                               atol=1e-11 * np.abs(jg).max())
    tcase = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    pb, pg = ref.nekbone_ax_powers_plain(
        p2, r2, tcase.D, ops.diag_metric(tcase.g, E, n), mx, my, mz, cx, cy,
        cz, torch.tensor([1.0 / theta], dtype=torch.float64), n=n, s=s)
    em_plain = ref.sstep_gram_emulated(p2, r2, pb, cx, cy, cz, n=n, s=s)
    np.testing.assert_allclose(em_plain.numpy(), pg.numpy(), rtol=1e-12,
                               atol=1e-12 * float(pg.abs().max()))


def test_sstep_gram_emulated_sums_in_the_kernels_order():
    """Each pair's partial is, for each row j of a layer, the sum of
    (V_a c) V_b over the layers in order and each layer's nodes in order,
    from 0, and then the rows' sums in order, each sum rounded on its own:
    on values where the order shows (ones and terms below their rounding),
    the emulation equals that loop in Python floats."""
    n, s = 3, 1
    E, K_ = 1, 3
    rng = np.random.default_rng(7)
    ones = torch.ones(1, n, dtype=torch.float64)
    V = torch.as_tensor(rng.choice([1.0, 1e-16, -1.0, 3e-17],
                                   size=(E, K_, n, n, n)))
    em = ref.sstep_gram_emulated(V[:, 0].reshape(E, -1),
                                 V[:, 2].reshape(E, -1),
                                 V[:, 1].reshape(E, 1, -1), ones, ones, ones,
                                 n=n, s=s)
    for a in range(K_):
        for b in range(a, K_):
            rows = []
            for j in range(n):
                acc = 0.0
                for k in range(n):
                    for i in range(n):
                        acc = acc + float(V[0, a, k, j, i]) * float(
                            V[0, b, k, j, i])
                rows.append(acc)
            want = rows[0]
            for x in rows[1:]:
                want = want + x
            assert float(em[0, a, b]) == want


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b", range(1, 9))
def test_k6_lane_groups_cover_every_lane_once(b):
    groups = K.k6_lane_groups(b)
    lanes = [lane for g in groups for lane in g]
    assert lanes == list(range(b))            # each lane once, in order
    assert len(groups) == -(-b // K.K6_LANES)  # the kernel's grid.y
    assert all(len(g) == K.K6_LANES for g in groups[:-1])
    assert len(groups[-1]) == b - K.K6_LANES * (len(groups) - 1) >= 1


def test_k6_lanes_are_the_sources():
    src = (CSRC / "nekbone_ax_slab_block.cu").read_text()
    assert int(re.search(r"constexpr int kLanes = (\d+);", src).group(1)) \
        == K.K6_LANES
    with pytest.raises(ValueError):
        K.k6_lane_groups(0)


# ---------------------------------------------------------------------------
# The wrappers on the CPU
# ---------------------------------------------------------------------------
def test_k8_k6_wrappers_on_cpu_are_the_plain_versions():
    rng = np.random.default_rng(9)
    n, grid = 4, (2, 2, 2)
    case = TorchCase(n=n, grid=grid, dtype=torch.float64, device="cpu")
    E, n3 = case.mesh.nelt, n ** 3
    (mx, my, mz), (cx, cy, cz) = ops.slab_axis_factors(
        grid, n, torch.float64, "cpu")
    g3 = ops.diag_metric(case.g, E, n)
    p2 = torch.as_tensor(rng.normal(size=(E, n3)))
    r2 = torch.as_tensor(rng.normal(size=(E, n3)))
    ith = torch.tensor([0.4], dtype=torch.float64)
    args = (p2, r2, case.D, g3, mx, my, mz, cx, cy, cz, ith)
    for s in (1, 3):
        got = K.nekbone_ax_powers_cuda(*args, n=n, s=s)
        want = K.nekbone_ax_powers_plain(*args, n=n, s=s)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for b in (1, 3):
        P = torch.as_tensor(rng.normal(size=(b, E, n3)))
        R = torch.as_tensor(rng.normal(size=(b, E, n3)))
        beta = torch.as_tensor(rng.normal(size=b))
        got = K.nekbone_ax_slab_block_cuda(P, R, case.D, g3, mx, my, mz,
                                           beta, n=n)
        want = K.nekbone_ax_slab_block_plain(P, R, case.D, g3, mx, my, mz,
                                             beta, n=n)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
