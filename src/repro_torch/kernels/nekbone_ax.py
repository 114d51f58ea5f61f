"""Wrappers of the CUDA kernels of the Nekbone operator, CG and PCG.

* ``nekbone_ax_cuda`` — K1, ``csrc/nekbone_ax.cu``, replaces the reference's
  ``kernels/nekbone_ax.py:nekbone_ax_kernel`` (K3's walker over the
  elements, :func:`k1_plan`, with a layer sweep that reads the layer in
  16-byte vectors);
* ``nekbone_ax_slab_cuda`` — K4, ``csrc/nekbone_ax_slab.cu``, replaces
  ``nekbone_ax_slab_kernel`` (persistent blocks that stage the next
  element's operands while they sweep the current one; :func:`k4_plan`);
* ``nekbone_cg_update_cuda`` — K5, ``csrc/nekbone_cg_update.cu``, replaces
  ``nekbone_cg_update_kernel`` (K4's walker skeleton over the elements,
  :func:`k5_plan`);
* ``nekbone_pcg_update_cuda`` — K10, ``csrc/nekbone_pcg_update.cu``,
  replaces ``nekbone_pcg_update_kernel`` (K5's walker over x, p, z, w and
  invd, :func:`k10_plan`);
* ``nekbone_cheb_apply_cuda`` — K11, ``csrc/nekbone_cheb_apply.cu``,
  replaces ``nekbone_cheb_apply_kernel`` (one cooperative launch per call,
  its grid and variant chosen by :func:`k11_plan`);
* ``nekbone_interp_cuda`` — K12, ``csrc/nekbone_interp.cu``, replaces
  ``nekbone_interp_kernel`` (the p-multigrid transfers; a layer walker over
  groups of elements, thread (jo, io) of an element owning its output
  column, :func:`k12_plan`);
* ``nekbone_ax_slab_block_cuda`` — K6, ``csrc/nekbone_ax_slab_block.cu``,
  replaces ``nekbone_ax_slab_block_kernel`` (K4 over b right-hand sides,
  the lanes in pairs through one layer sweep, :func:`k6_lane_groups`);
* ``nekbone_cg_update_block_cuda`` — K7,
  ``csrc/nekbone_cg_update_block.cu``, replaces
  ``nekbone_cg_update_block_kernel`` (K5's walker over the b E work items
  of b right-hand sides, lane-major, :func:`k7_plan`);
* ``nekbone_ax_pap_cuda`` — K3, and ``nekbone_ax_dots_cuda`` — K2, both
  ``csrc/nekbone_ax_dots.cu``, replace ``nekbone_ax_pap_kernel`` and
  ``nekbone_ax_dots_kernel`` (the v1 fused iteration's operator; K4's
  design, :func:`k3_plan`);
* ``nekbone_ax_powers_cuda`` — K8, ``csrc/nekbone_ax_powers.cu``, replaces
  ``nekbone_ax_powers_kernel`` (the s-step basis and Gram; one cooperative
  launch per call, its grid chosen by :func:`k8_plan`);
* ``nekbone_sstep_update_cuda`` — K9, ``csrc/nekbone_sstep_update.cu``,
  replaces ``nekbone_sstep_update_kernel`` (the s-step multi-axpy; K5's
  walker over x, p, r and the element's basis block, :func:`k9_plan`).

Every wrapper takes the kernel's flat operands ((E, n^3) fields, or
(b, E, n^3) for K6 and K7), and:

* for tensors on the CPU, returns its plain PyTorch version
  (kernels/ref.py) — the tests' path;
* for CUDA tensors, checks device, dtype, shape and contiguity, allocates
  the outputs, launches the kernel on the current stream, raises if the
  launch returned an error, and adds one to its count in
  ``_build.LAUNCHES``.
  There is no fallback: a CUDA tensor the kernel does not take raises.

On either path, while ``obs/drift.py`` measures, the wrapper charges the
bytes of its operands and results once (``_build.charged``).

Every kernel is built for f64 and f32, one dtype for all operands, and
for the two bf16 operand mixes of :data:`MIXES` — ``bf16`` (every operand
bf16) and ``bf16_ir`` (bf16 vectors; x and the operator's data in f32) —
with f32 scalars, partials and (K8, K11) unassembled operator outputs and
recurrence state; the dtype of each operand picks the build.

The kernels are built from the sources at first use (kernels/_build.py).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (nekbone_ax_dots_plain,
                                     nekbone_ax_pap_plain,
                                     nekbone_ax_plain,
                                     nekbone_ax_powers_plain,
                                     nekbone_ax_slab_block_plain,
                                     nekbone_ax_slab_plain,
                                     nekbone_cg_update_block_plain,
                                     nekbone_cg_update_plain,
                                     nekbone_cheb_apply_plain,
                                     nekbone_interp_plain,
                                     nekbone_pcg_update_plain,
                                     nekbone_sstep_update_plain)

__all__ = ["nekbone_ax_cuda",
           "nekbone_ax_slab_cuda", "nekbone_cg_update_cuda",
           "nekbone_pcg_update_cuda", "nekbone_cheb_apply_cuda",
           "nekbone_ax_plain", "nekbone_ax_slab_plain",
           "nekbone_cg_update_plain", "nekbone_pcg_update_plain",
           "nekbone_cheb_apply_plain", "nekbone_interp_cuda",
           "nekbone_interp_plain", "nekbone_ax_slab_block_cuda",
           "nekbone_ax_slab_block_plain", "nekbone_cg_update_block_cuda",
           "nekbone_cg_update_block_plain", "nekbone_ax_pap_cuda",
           "nekbone_ax_pap_plain", "nekbone_ax_dots_cuda",
           "nekbone_ax_dots_plain", "nekbone_ax_powers_cuda",
           "nekbone_ax_powers_plain", "nekbone_sstep_update_cuda",
           "nekbone_sstep_update_plain", "N_RANGE", "INTERP_PAIRS",
           "SSTEP_MAX_S", "MIXES", "build_for", "CoopPlan",
           "device_memory_plan", "k11_plan", "k11_state_bytes",
           "nekbone_cheb_apply_plan", "k8_plan", "k8_scratch_bytes",
           "nekbone_ax_powers_plan", "K6_LANES", "k6_lane_groups", "STAGES",
           "WalkPlan", "walk_slot_bytes", "k4_operands", "k3_operands",
           "k5_operands", "k1_operands", "k9_operands", "k4_plan",
           "k3_plan", "k5_plan", "k7_plan", "k1_plan", "k9_plan",
           "k10_operands", "k10_plan", "walk_plan", "walk_launch_info",
           "InterpPlan", "K12_MIN_THREADS", "K12_STAGES", "k12_group_align",
           "k12_lanes", "k12_max_threads", "k12_dyn_bytes", "k12_plan",
           "nekbone_interp_plan", "nekbone_interp_floor"]

# The n the kernels are instantiated for (template parameter).
N_RANGE = range(2, 17)
# The (nin, nout) pairs K12 is instantiated for: the steps of the
# p-multigrid ladder n -> ceil(n/2) and back, for n = 3..16.
INTERP_PAIRS = frozenset(
    pair for nf in range(3, 17) for pair in ((nf, (nf + 1) // 2),
                                             ((nf + 1) // 2, nf)))
# The largest s the s-step kernels K8 and K9 take (kSstepMaxS of
# csrc/common.cuh: the Gram tile and the coefficient rows are sized by it).
SSTEP_MAX_S = 10

# The operand mixes of the builds, by role: S the CG vectors (and the mask
# and c fields or factors), X the solution x, O the operator's data (D, the
# metric, K10's invd, K12's transfer matrix), A the scalars (alpha, beta,
# 1/theta, the s-step and Chebyshev coefficients) and the partials.  f64
# and f32 are one dtype throughout; the bf16 mixes accumulate in f32.
_F64, _F32, _BF16 = torch.float64, torch.float32, torch.bfloat16
MIXES = {
    "f64": dict(S=_F64, X=_F64, O=_F64, A=_F64),
    "f32": dict(S=_F32, X=_F32, O=_F32, A=_F32),
    "bf16": dict(S=_BF16, X=_BF16, O=_BF16, A=_F32),
    "bf16_ir": dict(S=_BF16, X=_F32, O=_F32, A=_F32),
}
_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: pointers, then the ints, then the stream.
_ARGTYPES = {
    "nekbone_ax": [_P] * 4 + [_I] * 7 + [_P],
    "nekbone_ax_slab": [_P] * 11 + [_I] * 9 + [_P],
    "nekbone_cg_update": [_P] * 11 + [_I] * 9 + [_P],
    "nekbone_cg_update_planes": [_P] * 13 + [_I] * 9 + [_P],
    "nekbone_pcg_update": [_P] * 13 + [_I] * 9 + [_P],
    "nekbone_pcg_update_planes": [_P] * 15 + [_I] * 9 + [_P],
    "nekbone_cheb_apply": [_P] * 17 + [_I] * 8 + [_P],
    "nekbone_interp": [_P] * 3 + [_I] * 7 + [_P],
    "nekbone_ax_slab_block": [_P] * 11 + [_I] * 5 + [_P],
    "nekbone_cg_update_block": [_P] * 11 + [_I] * 10 + [_P],
    "nekbone_ax_pap": [_P] * 6 + [_I] * 7 + [_P],
    "nekbone_ax_dots": [_P] * 9 + [_I] * 7 + [_P],
    "nekbone_ax_powers": [_P] * 17 + [_I] * 7 + [_P],
    "nekbone_sstep_update": [_P] * 12 + [_I] * 10 + [_P],
}
# Entry points that live in another stem's library.
_LIBRARY = {"nekbone_ax_pap": "nekbone_ax_dots",
            "nekbone_cg_update_planes": "nekbone_cg_update",
            "nekbone_pcg_update_planes": "nekbone_pcg_update"}


def build_for(stem: str, **tensors: tuple) -> str:
    """The build (``MIXES`` key) the operands of a launch of ``stem`` pick.

    Each operand is ``(tensor, shape)`` or ``(tensor, shape, role)``, the
    role a key of a ``MIXES`` entry (``S`` when omitted); the first ``S``
    operand's dtype selects the storage, and every operand must then match
    one build role by role.  A storage dtype no build has (float16, say)
    raises ``NotImplementedError``; a mix of dtypes that matches no build
    raises ``TypeError``.  The answer is cached by the operands' (name, role,
    dtype), so a launch pays for one tuple and one lookup.
    """
    return _build_for(stem, tuple(
        (name, spec[2] if len(spec) > 2 else "S", spec[0].dtype)
        for name, spec in tensors.items()))


@functools.lru_cache(maxsize=None)
def _build_for(stem: str, signature: tuple) -> str:
    storage = next(dtype for _, role, dtype in signature if role == "S")
    mixes = [m for m, dt in MIXES.items() if dt["S"] == storage]
    if not mixes:
        raise NotImplementedError(
            f"{stem}: the CUDA kernel is built for float64, float32 and "
            f"bfloat16 storage, not {storage}")
    mix = next((m for m in mixes if all(
        dtype == MIXES[m][role] for _, role, dtype in signature)), None)
    if mix is None:
        got = {name: dtype for name, _, dtype in signature}
        raise TypeError(
            f"{stem}: operand dtypes {got} match no build; builds by role "
            "(S vectors, X solution, O operator, A scalars): "
            + "; ".join(f"{m} {MIXES[m]}" for m in mixes))
    return mix


def _check(stem: str, n: int, device: torch.device,
           **tensors: tuple) -> str:
    """Check the operands of a launch (device, n, dtypes, shapes,
    contiguity) and return the build they pick (:func:`build_for`)."""
    if device.type != "cuda":
        raise ValueError(f"{stem}: tensors must be on the CPU or a CUDA "
                         f"device, got {device}")
    if n not in N_RANGE:
        raise ValueError(f"{stem}: n={n} outside the built range 2..16")
    mix = build_for(stem, **tensors)
    for name, (t, shape, *_) in tensors.items():
        if t.device != device:
            raise ValueError(f"{stem}: {name} is on {t.device}, not {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{stem}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{stem}: {name} must be contiguous")
    return mix


def _launch(stem: str, mix: str, device: torch.device, tensors,
            ints) -> None:
    # ``ints`` follow the tensors' pointers; the planes entry points take
    # their two plane pointers (0 for an absent one) first among them
    _build.launch(f"{stem}_{mix}", _ARGTYPES[stem], device,
                  (*(t.data_ptr() for t in tensors), *ints),
                  library=f"{_LIBRARY.get(stem, stem)}_{mix}")


@_build.charged
def nekbone_ax_cuda(u2: torch.Tensor, D: torch.Tensor, g2: torch.Tensor, *,
                    n: int) -> torch.Tensor:
    """K1: ``w = D^T G D u``.  u2: (E, n^3); D: (n, n); g2: (E, 6, n^3).

    Builds by operand dtype (:data:`MIXES`): u2 in S, D and g2 in O.
    Returns ``w`` in S, computed in A and rounded once.  One launch of the
    grid :func:`k1_plan` sizes, staging what it says.
    """
    if u2.device.type == "cpu":
        return nekbone_ax_plain(u2, D, g2, n=n)
    E = u2.shape[0]
    n3 = n ** 3
    mix = _check("nekbone_ax", n, u2.device, u2=(u2, (E, n3)),
                 D=(D, (n, n), "O"), g2=(g2, (E, 6, n3), "O"))
    plan = _walk_launch_plan("nekbone_ax", k1_plan, E, n, mix, u2.device,
                             (u2, g2), any_head=True)
    w2 = torch.empty_like(u2)
    _launch("nekbone_ax", mix, u2.device, (u2, D, g2, w2),
            (E, n, *plan.launch_ints))
    return w2


@_build.charged
def nekbone_ax_slab_cuda(p2, r2, D, g3, mx, my, mz, beta, *, n: int):
    """K4: ``p = r + beta p2``, masked diagonal-metric Ax, pap partials.

    Operands as :func:`repro_torch.kernels.ref.nekbone_ax_slab_plain`; the
    element grid is ``(len(mx), len(my), len(mz))``.  One launch of the
    grid :func:`k4_plan` sizes, staging what it says.  Builds by operand
    dtype (:data:`MIXES`): p2, r2 and the factors in S, D and g3 in O, beta
    in A.  Returns ``(p, w, pap)`` with ``p`` and the unassembled ``w`` in
    S and ``pap`` of shape (E,) in A.
    """
    if p2.device.type == "cpu":
        return nekbone_ax_slab_plain(p2, r2, D, g3, mx, my, mz, beta, n=n)
    ex, ey, ez = mx.shape[0], my.shape[0], mz.shape[0]
    E = ex * ey * ez
    n3 = n ** 3
    mix = _check("nekbone_ax_slab", n, p2.device, p2=(p2, (E, n3)),
                 r2=(r2, (E, n3)), D=(D, (n, n), "O"),
                 g3=(g3, (E, 3, n3), "O"), mx=(mx, (ex, n)),
                 my=(my, (ey, n)), mz=(mz, (ez, n)),
                 beta=(beta.reshape(1), (1,), "A"))
    plan = _walk_launch_plan("nekbone_ax_slab", k4_plan, E, n, mix,
                             p2.device, (p2, r2, g3))
    p_out = torch.empty_like(p2)
    w2 = torch.empty_like(p2)
    pap = torch.empty(E, dtype=MIXES[mix]["A"], device=p2.device)
    _launch("nekbone_ax_slab", mix, p2.device,
            (p2, r2, D, g3, mx, my, mz, beta, p_out, w2, pap),
            (ex, ey, ez, n, *plan.launch_ints))
    return p_out, w2, pap


def _plane_operands(stem: str, mix: str, ex: int, ey: int, n: int,
                    device, from_below, from_above) -> tuple[int, int]:
    """Check the edge planes of a K5 or K10 launch and return their
    pointers (0 for an absent one): ``(EY*EX, n, n)``, contiguous, on
    ``device``, in the build's accumulation dtype A."""
    ptrs = []
    for name, t in (("from_below", from_below), ("from_above", from_above)):
        if t is None:
            ptrs.append(0)
            continue
        if (t.device != device or t.dtype != MIXES[mix]["A"]
                or tuple(t.shape) != (ey * ex, n, n)
                or not t.is_contiguous()):
            raise ValueError(
                f"{stem}: {name} must be a contiguous ({ey * ex}, {n}, {n}) "
                f"{MIXES[mix]['A']} tensor on {device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
        ptrs.append(t.data_ptr())
    return ptrs[0], ptrs[1]


@_build.charged
def nekbone_cg_update_cuda(x2, p2, r2, w2, alpha, cx, cy, cz, *, n: int,
                           from_below=None, from_above=None):
    """K5: assemble ``w``, ``x += alpha p``, ``r -= alpha w``, rcr partials.

    Operands as :func:`repro_torch.kernels.ref.nekbone_cg_update_plain`;
    ``w2`` is K4's unassembled output.  One launch of the grid
    :func:`k5_plan` sizes, staging what it says.  Builds by operand dtype
    (:data:`MIXES`): x2 in X, p2, r2, w2 and the factors in S, alpha in A.
    Returns ``(x, r, rcr)`` with ``rcr`` of shape (E,) in A.

    ``from_below``/``from_above`` (optional, ``(EY*EX, n, n)`` in A): a
    neighbour shard's x,y-assembled edge plane
    (``core/gs.edge_planes``), added in the z step of the bottom layer's
    ``k = 0`` face or the top layer's ``k = n-1`` face.  With either given
    the launch is the planes instantiation of the kernel, counted as
    ``nekbone_cg_update_planes``; with neither, the single-shard one.
    """
    if x2.device.type == "cpu":
        return nekbone_cg_update_plain(x2, p2, r2, w2, alpha, cx, cy, cz, n=n,
                                       from_below=from_below,
                                       from_above=from_above)
    ex, ey, ez = cx.shape[0], cy.shape[0], cz.shape[0]
    E = ex * ey * ez
    n3 = n ** 3
    mix = _check("nekbone_cg_update", n, x2.device, x2=(x2, (E, n3), "X"),
                 p2=(p2, (E, n3)), r2=(r2, (E, n3)), w2=(w2, (E, n3)),
                 alpha=(alpha.reshape(1), (1,), "A"), cx=(cx, (ex, n)),
                 cy=(cy, (ey, n)), cz=(cz, (ez, n)))
    plan = _walk_launch_plan("nekbone_cg_update", k5_plan, E, n, mix,
                             x2.device, (x2, p2, r2, w2), any_head=True)
    x_out = torch.empty_like(x2)
    r_out = torch.empty_like(r2)
    rcr = torch.empty(E, dtype=MIXES[mix]["A"], device=x2.device)
    tensors = (x2, p2, r2, w2, alpha, cx, cy, cz, x_out, r_out, rcr)
    ints = (ex, ey, ez, n, *plan.launch_ints)
    if from_below is None and from_above is None:
        _launch("nekbone_cg_update", mix, x2.device, tensors, ints)
    else:
        planes = _plane_operands("nekbone_cg_update", mix, ex, ey, n,
                                 x2.device, from_below, from_above)
        _launch("nekbone_cg_update_planes", mix, x2.device, tensors,
                (*planes, *ints))
    return x_out, r_out, rcr


@_build.charged
def nekbone_pcg_update_cuda(x2, p2, z2, w2, alpha, invd2, cx, cy, cz, *,
                            n: int, from_below=None, from_above=None):
    """K10: assemble ``w``, ``x += alpha p``, ``z -= alpha invd w``, partials.

    Operands as :func:`repro_torch.kernels.ref.nekbone_pcg_update_plain`;
    ``w2`` is K4's unassembled output.  One launch of the grid
    :func:`k10_plan` sizes, staging what it says.  Builds by operand dtype
    (:data:`MIXES`): x2 in X, p2, z2, w2 and the factors in S, invd2 in O,
    alpha in A.  Returns ``(x, z, rtz, rcr)`` with ``rtz`` and ``rcr`` of
    shape (E,) in A.  ``from_below``/``from_above`` as
    :func:`nekbone_cg_update_cuda` takes them (the planes instantiation,
    counted as ``nekbone_pcg_update_planes``).
    """
    if x2.device.type == "cpu":
        return nekbone_pcg_update_plain(x2, p2, z2, w2, alpha, invd2, cx, cy,
                                        cz, n=n, from_below=from_below,
                                        from_above=from_above)
    ex, ey, ez = cx.shape[0], cy.shape[0], cz.shape[0]
    E = ex * ey * ez
    n3 = n ** 3
    mix = _check("nekbone_pcg_update", n, x2.device,
                 x2=(x2, (E, n3), "X"), p2=(p2, (E, n3)), z2=(z2, (E, n3)),
                 w2=(w2, (E, n3)), alpha=(alpha.reshape(1), (1,), "A"),
                 invd2=(invd2, (E, n3), "O"), cx=(cx, (ex, n)),
                 cy=(cy, (ey, n)), cz=(cz, (ez, n)))
    plan = _walk_launch_plan("nekbone_pcg_update", k10_plan, E, n, mix,
                             x2.device, (x2, p2, z2, w2, invd2),
                             any_head=True)
    x_out = torch.empty_like(x2)
    z_out = torch.empty_like(z2)
    parts = torch.empty(2, E, dtype=MIXES[mix]["A"], device=x2.device)
    tensors = (x2, p2, z2, w2, alpha, invd2, cx, cy, cz, x_out, z_out,
               parts[0], parts[1])
    ints = (ex, ey, ez, n, *plan.launch_ints)
    if from_below is None and from_above is None:
        _launch("nekbone_pcg_update", mix, x2.device, tensors, ints)
    else:
        planes = _plane_operands("nekbone_pcg_update", mix, ex, ey, n,
                                 x2.device, from_below, from_above)
        _launch("nekbone_pcg_update_planes", mix, x2.device, tensors,
                (*planes, *ints))
    return x_out, z_out, parts[0], parts[1]


@dataclasses.dataclass(frozen=True)
class CoopPlan:
    """One launch of a persistent cooperative kernel (K8, K11): block b of
    ``grid`` owns elements ``[b * per_block, (b + 1) * per_block)`` (z-major,
    the last range cut at E) for the whole call; ``resident`` (K11 only)
    keeps the owned elements' d, res and z in the block's dynamic shared
    memory, else in device memory; ``smem_bytes`` is the dynamic shared
    memory a block takes and ``blocks_per_sm`` the residency the grid was
    sized by."""
    resident: bool
    per_block: int
    grid: int
    blocks_per_sm: int
    smem_bytes: int

    @property
    def variant(self) -> str:
        return "shared" if self.resident else "device"


def _check_plan(what: str, E: int, sm_count: int, slices: int) -> None:
    if E < 1 or sm_count < 1 or slices < 1:
        raise ValueError(f"{what}: E={E}, sm_count={sm_count}, "
                         f"slices={slices}")


def device_memory_plan(E: int, sm_count: int, fit: int, slices: int,
                       dyn_bytes: int) -> CoopPlan:
    """The device-memory variant of a cooperative kernel (K8, and K11 where
    its state does not fit), ``fit`` >= 1 blocks an SM with ``dyn_bytes``
    of dynamic shared memory each, a residency that does not depend on E:
    every block owns the least multiple m of ``slices`` elements with
    ceil(E / m) blocks resident at once."""
    m = -(-E // (sm_count * fit))
    m = -(-m // slices) * slices
    return CoopPlan(False, m, -(-E // m), fit, dyn_bytes)


def k11_state_bytes(n: int, dtype: torch.dtype,
                    accum: torch.dtype | None = None) -> int:
    """d, res and z of one element, stored in ``dtype`` and summed in
    ``accum`` (by default ``dtype``): the shared memory it takes resident.
    The recurrence's state is ``accum`` whatever the storage (z is rounded
    to ``dtype`` once, on its way out), so this is 3 n^3 ``accum`` values
    (csrc/nekbone_cheb_apply.cu ``cheb_dyn_bytes``)."""
    return 3 * n ** 3 * (accum or dtype).itemsize


def k11_plan(E: int, n: int, dtype: torch.dtype, sm_count: int,
             blocks_per_sm, smem_per_block: int, *,
             slices: int = 1, accum: torch.dtype | None = None) -> CoopPlan:
    """K11's variant and grid for E elements of degree n - 1, stored in
    ``dtype`` and summed in ``accum`` (by default ``dtype``).

    ``blocks_per_sm(resident, dyn_bytes)`` is how many blocks of that
    variant an SM holds with ``dyn_bytes`` of dynamic shared memory each (on
    the card, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
    ``smem_per_block`` the most dynamic shared memory a block of the
    shared-memory variant may take.  Every block of a cooperative launch is
    resident at once, so the grid is at most ``sm_count`` times that
    residency.  A block works on ``slices`` elements side by side, so it
    owns a multiple m of them.  The shared-memory variant is taken if and
    only if some such m fits both: m elements' state in one block, and
    ceil(E / m) blocks on the card at the residency that state allows; the
    least such m.  Otherwise the device-memory variant
    (:func:`device_memory_plan`, with one n^3 column copy of ``accum``
    values per slice in shared memory).  Raises ``ValueError`` where
    neither can run (no block of the device variant fits an SM).
    """
    _check_plan("k11_plan", E, sm_count, slices)

    def round_up(m):
        return -(-m // slices) * slices

    state = k11_state_bytes(n, dtype, accum)
    m = slices
    if m * state <= smem_per_block:
        fit = blocks_per_sm(True, m * state)
        # the residency falls as m grows, so no m below this one fits
        m = round_up(max(m, -(-E // max(sm_count * fit, 1))))
        while m * state <= smem_per_block:
            fit = blocks_per_sm(True, m * state)
            grid = -(-E // m)
            if fit >= 1 and grid <= sm_count * fit:
                return CoopPlan(True, m, grid, fit, m * state)
            m += slices
    column = slices * n ** 3 * (accum or dtype).itemsize
    fit = blocks_per_sm(False, column) if column <= smem_per_block else 0
    if fit < 1:
        raise ValueError(f"k11_plan: no block of K11 (n={n}, {dtype}) is "
                         "resident on an SM in either variant")
    return device_memory_plan(E, sm_count, fit, slices, column)


def k8_scratch_bytes(n: int, s: int, dtype: torch.dtype, slices: int,
                     accum: torch.dtype | None = None) -> int:
    """K8's shared scratch of a block, its vectors stored in ``dtype`` and
    summed in ``accum`` (by default ``dtype``): per slice the p and the r
    chain's operator input columns (n^3 values each, in ``dtype``) during
    the steps, then the Gram's ring of staged layers of the 2s + 1 vectors
    and c (4 layers up to s = 4, 2 past it; rows padded to n + 1), and its
    sums (9 n^2), both in ``accum``; a slice's share is whole ``accum``
    values (csrc/nekbone_ax_powers.cu ``scratch_values``)."""
    a = (accum or dtype).itemsize
    ring = 4 if s <= 4 else 2
    column = -(-2 * n ** 3 * dtype.itemsize // a)
    return slices * max(column, ring * (2 * s + 2) * n * (n + 1),
                        9 * n ** 2) * a


def k8_plan(E: int, n: int, dtype: torch.dtype, sm_count: int,
            blocks_per_sm, smem_per_block: int, *, s: int,
            slices: int = 1, accum: torch.dtype | None = None) -> CoopPlan:
    """K8's grid for E elements of degree n - 1 at cycle length s, stored
    in ``dtype`` and summed in ``accum`` (by default ``dtype``): a block
    takes :func:`k8_scratch_bytes` of dynamic shared memory and reads the
    metric through L2 (:func:`device_memory_plan`; ``blocks_per_sm`` and
    ``smem_per_block`` as for :func:`k11_plan`, asked only for
    ``resident=False``).  Raises ``ValueError`` where no block fits an
    SM."""
    _check_plan("k8_plan", E, sm_count, slices)
    scratch = k8_scratch_bytes(n, s, dtype, slices, accum)
    fit = blocks_per_sm(False, scratch) if scratch <= smem_per_block else 0
    if fit < 1:
        raise ValueError(f"k8_plan: no block of K8 (n={n}, s={s}, {dtype}) "
                         "is resident on an SM")
    return device_memory_plan(E, sm_count, fit, slices, scratch)


# The ring's depth of the walkers (K1, K4, K3, K2, K5, K7, K9, K10): the
# element being swept and the next one.  The kernels take 1..4
# (csrc/common.cuh kMaxStages).
STAGES = 2


@dataclasses.dataclass(frozen=True)
class WalkPlan:
    """One launch of a walker (K1, K4, K3, K2, K5, K9, K10; K7 over its work
    items): block b of ``grid`` owns the z-major elements ``[b *
    per_block, (b + 1) * per_block)`` (the last range cut at E) and walks
    them, while a ring of ``stages`` stages in its dynamic shared memory
    (``smem_bytes``) holds the ``staged`` operands of the next elements,
    filled by TMA bulk copies (``bulk``) or per-thread ``cp.async``; the
    other operands are read from device memory.  ``blocks_per_sm`` is the
    residency the grid was sized by."""
    per_block: int
    grid: int
    blocks_per_sm: int
    smem_bytes: int
    stages: int
    staged: tuple[str, ...]
    operands: tuple[str, ...]
    bulk: bool

    @property
    def copy(self) -> str:
        return "bulk" if self.bulk else "cp.async"

    @property
    def staged_mask(self) -> int:
        return sum(1 << self.operands.index(name) for name in self.staged)

    @property
    def launch_ints(self) -> tuple[int, ...]:
        """(per_block, grid, stages, staged, bulk): the C entry's plan."""
        return (self.per_block, self.grid, self.stages, self.staged_mask,
                int(self.bulk))


def walk_slot_bytes(nbytes: int, bulk: bool) -> int:
    """An operand's slot in a stage (csrc/common.cuh ``walk_slot_bytes``):
    its bytes per element on the bulk path; on the cp.async path rounded
    to 16 with a 16-byte margin for the copy window."""
    return nbytes if bulk else -(-nbytes // 16) * 16 + 16


def k4_operands(n: int, mix: str) -> dict[str, int]:
    """K4's stageable operands and their bytes per element: p_prev and r
    (n^3 values in S) and the metric diagonals (3 n^3 in O)."""
    s, o = MIXES[mix]["S"].itemsize, MIXES[mix]["O"].itemsize
    return {"p_prev": n ** 3 * s, "r": n ** 3 * s, "g3": 3 * n ** 3 * o}


def k3_operands(n: int, mix: str) -> dict[str, int]:
    """K3's (and K2's) stageable operands and their bytes per element: p
    (n^3 values in S), the metric (6 n^3 in O) and the mask (n^3 in S)."""
    s, o = MIXES[mix]["S"].itemsize, MIXES[mix]["O"].itemsize
    return {"p": n ** 3 * s, "g": 6 * n ** 3 * o, "mask": n ** 3 * s}


def k5_operands(n: int, mix: str) -> dict[str, int]:
    """K5's (and K7's, per work item) stageable operands and their bytes
    per element: x (n^3 values in X), p, r and w (n^3 in S)."""
    s, x = MIXES[mix]["S"].itemsize, MIXES[mix]["X"].itemsize
    return {"x": n ** 3 * x, "p": n ** 3 * s, "r": n ** 3 * s,
            "w": n ** 3 * s}


def k1_operands(n: int, mix: str) -> dict[str, int]:
    """K1's stageable operands and their bytes per element: u (n^3 values
    in S) and the metric (6 n^3 in O)."""
    s, o = MIXES[mix]["S"].itemsize, MIXES[mix]["O"].itemsize
    return {"u": n ** 3 * s, "g": 6 * n ** 3 * o}


def k9_operands(n: int, s: int, mix: str) -> dict[str, int]:
    """K9's stageable operands and their bytes per element at cycle length
    s: x (n^3 values in X), p and r (n^3 in S) and the element's basis block
    ((2s - 1) n^3 in S, contiguous in the (E, 2s-1, n^3) layout)."""
    v, x = MIXES[mix]["S"].itemsize, MIXES[mix]["X"].itemsize
    return {"x": n ** 3 * x, "p": n ** 3 * v, "r": n ** 3 * v,
            "basis": (2 * s - 1) * n ** 3 * v}


def k10_operands(n: int, mix: str) -> dict[str, int]:
    """K10's stageable operands and their bytes per element: x (n^3 values
    in X), p, z and w (n^3 in S) and invd (n^3 in O)."""
    v, x, o = (MIXES[mix][role].itemsize for role in ("S", "X", "O"))
    return {"x": n ** 3 * x, "p": n ** 3 * v, "z": n ** 3 * v,
            "w": n ** 3 * v, "invd": n ** 3 * o}


def walk_plan(what: str, E: int, operands: dict[str, int], sm_count: int,
              blocks_per_sm, smem_per_block: int, *,
              aligned: bool = True) -> WalkPlan:
    """The launch plan of a walker over E elements.

    ``operands`` are the operands a ring may stage with their bytes per
    element, in the kernel's order; ``blocks_per_sm(dyn_bytes)`` is how many
    blocks an SM holds with that much dynamic shared memory each (on the
    card, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
    ``smem_per_block`` the most a block may take.  The copy path is the
    bulk one where every operand's bytes are a multiple of 16 and its
    pointer 16-byte aligned (``aligned``), cp.async otherwise.  The
    residency comes first: the staged set is the one with the most bytes
    whose ring of :data:`STAGES` stages leaves as many blocks an SM as the
    block's registers allow (``blocks_per_sm(0)``), else one block fewer,
    and so on (ties: the earlier operands); each block owns the least count
    of elements that puts the whole grid on the card at once
    (:func:`device_memory_plan`), so it ends in one wave.  Raises
    ``ValueError`` where no ring of even one operand fits a block.
    """
    _check_plan(what, E, sm_count, 1)
    names = tuple(operands)
    bulk = aligned and all(b % 16 == 0 for b in operands.values())
    slots = {k: walk_slot_bytes(b, bulk) for k, b in operands.items()}
    subsets = [tuple(k for q, k in enumerate(names) if m >> q & 1)
               for m in range(1, 1 << len(names))]
    # most bytes first; among equals the one whose operands come first
    subsets.sort(key=lambda sub: (-sum(operands[k] for k in sub),
                                  [names.index(k) for k in sub]))
    for need in range(max(blocks_per_sm(0), 1), 0, -1):
        for sub in subsets:
            dyn = STAGES * sum(slots[k] for k in sub)
            if dyn > smem_per_block:
                continue
            fit = blocks_per_sm(dyn)
            if fit >= need:
                base = device_memory_plan(E, sm_count, fit, 1, dyn)
                return WalkPlan(base.per_block, base.grid, fit, dyn, STAGES,
                                sub, names, bulk)
    raise ValueError(
        f"{what}: no ring of {STAGES} stages of any of its operands "
        f"({', '.join(f'{k} {b} B' for k, b in operands.items())} per "
        f"element) fits a block resident on an SM ({smem_per_block} bytes "
        "of shared memory a block at most)")


def k4_plan(E: int, n: int, mix: str, sm_count: int, blocks_per_sm,
            smem_per_block: int, *, aligned: bool = True) -> WalkPlan:
    """K4's plan for E elements of degree n - 1 in build ``mix``
    (:func:`walk_plan` over :func:`k4_operands`)."""
    return walk_plan(f"k4_plan (n={n}, {mix})", E, k4_operands(n, mix),
                     sm_count, blocks_per_sm, smem_per_block,
                     aligned=aligned)


def k3_plan(E: int, n: int, mix: str, sm_count: int, blocks_per_sm,
            smem_per_block: int, *, aligned: bool = True) -> WalkPlan:
    """K3's and K2's plan for E elements of degree n - 1 in build ``mix``
    (:func:`walk_plan` over :func:`k3_operands`)."""
    return walk_plan(f"k3_plan (n={n}, {mix})", E, k3_operands(n, mix),
                     sm_count, blocks_per_sm, smem_per_block,
                     aligned=aligned)


def k1_plan(E: int, n: int, mix: str, sm_count: int, blocks_per_sm,
            smem_per_block: int, *, aligned: bool = True) -> WalkPlan:
    """K1's plan for E elements of degree n - 1 in build ``mix``
    (:func:`walk_plan` over :func:`k1_operands`): residency first, so at
    n = 10 f32 stages the metric alone (both operands leave no room for a
    fourth block an SM) and reads u from device memory; fp64 (2 x 56,000
    bytes at two blocks an SM), bf16 and ``bf16_ir`` stage both."""
    return walk_plan(f"k1_plan (n={n}, {mix})", E, k1_operands(n, mix),
                     sm_count, blocks_per_sm, smem_per_block,
                     aligned=aligned)


def _update_plan(what: str, items: int, operands: dict[str, int],
                 sm_count: int, blocks_per_sm, smem_per_block: int,
                 aligned: bool) -> WalkPlan:
    """:func:`walk_plan` over an update walker's ``operands`` (K5, K7, K9,
    K10)
    for ``items`` work items, its residency capped at what the ring of all
    of them allows."""
    bulk = aligned and all(b % 16 == 0 for b in operands.values())
    ring = STAGES * sum(walk_slot_bytes(b, bulk) for b in operands.values())
    cap = blocks_per_sm(ring) if ring <= smem_per_block else 0

    def fit(dyn):
        return min(blocks_per_sm(dyn), cap) if cap >= 1 \
            else blocks_per_sm(dyn)

    return walk_plan(what, items, operands, sm_count, fit, smem_per_block,
                     aligned=aligned)


def k5_plan(E: int, n: int, mix: str, sm_count: int, blocks_per_sm,
            smem_per_block: int, *, aligned: bool = True) -> WalkPlan:
    """K5's plan for E elements of degree n - 1 in build ``mix``:
    :func:`walk_plan` over :func:`k5_operands`, at the residency that the
    ring of all four operands allows.  The kernel does a few flops a node
    and stores straight from registers, so the staged bytes, not the
    blocks an SM, keep the memory busy: every operand is staged wherever
    one block of that ring fits an SM (at n = 10 in every build: 2 x 32,000
    bytes in fp64, 2 x 8,000 in bf16), and :func:`walk_plan`'s rule holds
    where none does."""
    return _update_plan(f"k5_plan (n={n}, {mix})", E, k5_operands(n, mix),
                        sm_count, blocks_per_sm, smem_per_block, aligned)


def k7_plan(E: int, n: int, mix: str, sm_count: int, blocks_per_sm,
            smem_per_block: int, *, b: int,
            aligned: bool = True) -> WalkPlan:
    """K7's plan for b lanes of E elements: :func:`k5_plan`'s over the b E
    work items, lane-major (item l E + e is element e of lane l), so that
    a block's range may cross from one lane into the next."""
    if b < 1:
        raise ValueError(f"k7_plan: b={b}")
    return _update_plan(f"k7_plan (n={n}, {mix}, b={b})", b * E,
                        k5_operands(n, mix), sm_count, blocks_per_sm,
                        smem_per_block, aligned)


def k9_plan(E: int, n: int, mix: str, sm_count: int, blocks_per_sm,
            smem_per_block: int, *, s: int,
            aligned: bool = True) -> WalkPlan:
    """K9's plan for E elements of degree n - 1 at cycle length s in build
    ``mix``: :func:`k5_plan`'s rule over :func:`k9_operands`.  All four
    are staged wherever one block of their ring fits an SM, at the
    residency that ring allows (s = 4, n = 10, fp64: 2 x 80,000 bytes, one
    block an SM), else :func:`walk_plan`'s rule holds (s = 10 in fp64: a
    basis block is 152,000 bytes, so x, p and r are staged and the basis is
    read from device memory)."""
    if not 1 <= s <= SSTEP_MAX_S:
        raise ValueError(f"k9_plan: s={s} outside 1..{SSTEP_MAX_S}")
    return _update_plan(f"k9_plan (n={n}, s={s}, {mix})", E,
                        k9_operands(n, s, mix), sm_count, blocks_per_sm,
                        smem_per_block, aligned)


def k10_plan(E: int, n: int, mix: str, sm_count: int, blocks_per_sm,
             smem_per_block: int, *, aligned: bool = True) -> WalkPlan:
    """K10's plan for E elements of degree n - 1 in build ``mix``:
    :func:`k5_plan`'s rule over :func:`k10_operands`.  All five are staged
    wherever one block of their ring fits an SM, at the residency that ring
    allows (n = 10: 2 x 40,000 bytes in fp64 at two blocks an SM, 2 x
    20,000 in f32, 2 x 10,000 in bf16, 2 x 14,000 in ``bf16_ir``), else
    :func:`walk_plan`'s rule holds."""
    return _update_plan(f"k10_plan (n={n}, {mix})", E, k10_operands(n, mix),
                        sm_count, blocks_per_sm, smem_per_block, aligned)


# The walkers' planners by stem.
_WALK_PLANNERS = {"nekbone_ax": k1_plan, "nekbone_ax_slab": k4_plan,
                  "nekbone_ax_pap": k3_plan, "nekbone_ax_dots": k3_plan,
                  "nekbone_cg_update": k5_plan,
                  "nekbone_cg_update_block": k7_plan,
                  "nekbone_sstep_update": k9_plan,
                  "nekbone_pcg_update": k10_plan}


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _coop_query(stem: str, mix: str, n: int, resident: bool, dyn: int,
                device: int) -> tuple[int, ...]:
    """The C side's occupancy query of ``stem`` (csrc/common.cuh
    ``coop_query``): (blocks per SM, static shared bytes, registers, the
    most dynamic shared bytes, SM count, cooperative launch supported,
    elements a block works on side by side).  The walkers (K1, K4, K3, K2,
    K5, K7, K9, K10) ignore ``resident``."""
    lib = _build.load(f"{_LIBRARY.get(stem, stem)}_{mix}")
    fn = getattr(lib, f"{stem}_query_{mix}")
    fn.argtypes = [_I, _I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        err = fn(n, int(resident), dyn, out)
    if err != 0:
        raise RuntimeError(f"{stem}: occupancy query failed with CUDA error "
                           f"{err}")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _coop_device_plan(stem: str, planner, E: int, n: int, mix: str,
                      device: int, **kw) -> CoopPlan:
    """``planner`` (:func:`k11_plan` or :func:`k8_plan`, with its keywords
    ``kw``) for ``stem``'s instantiation on ``device``, stored in the
    build's S and summed in its A; raises if the device cannot launch
    cooperatively or no variant runs."""
    info = _coop_query(stem, mix, n, True, 0, device)
    if not info[5]:
        raise RuntimeError(f"{stem}: the device does not support cooperative "
                           "launches (cudaDevAttrCooperativeLaunch)")

    def fit(resident, dyn):
        return _coop_query(stem, mix, n, resident, dyn, device)[0]

    return planner(E, n, MIXES[mix]["S"], info[4], fit, info[3],
                   slices=info[6], accum=MIXES[mix]["A"], **kw)


def _coop_plan_info(stem: str, planner, E: int, n: int, mix: str, device,
                    **kw) -> tuple[CoopPlan, dict]:
    index = _device_index(torch.device(device))
    plan = _coop_device_plan(stem, planner, E, n, mix, index, **kw)
    info = _coop_query(stem, mix, n, plan.resident, plan.smem_bytes, index)
    return plan, {"registers": info[2], "static_smem": info[1],
                  "sm_count": info[4], "slices": info[6]}


def nekbone_cheb_apply_plan(E: int, n: int, mix: str,
                            device="cuda") -> tuple[CoopPlan, dict]:
    """The plan K11 launches with for E elements in build ``mix`` (a
    :data:`MIXES` key) on ``device``, and the instantiation it runs:
    ``{"registers", "static_smem", "sm_count", "slices"}``."""
    return _coop_plan_info("nekbone_cheb_apply", k11_plan, E, n, mix, device)


def nekbone_ax_powers_plan(E: int, n: int, s: int, mix: str,
                           device="cuda") -> tuple[CoopPlan, dict]:
    """The plan K8 launches with for E elements at cycle length s in build
    ``mix`` on ``device``, and the instantiation it runs (as
    :func:`nekbone_cheb_apply_plan`)."""
    return _coop_plan_info("nekbone_ax_powers", k8_plan, E, n, mix, device,
                           s=s)


@functools.lru_cache(maxsize=None)
def _walk_device_plan(stem: str, planner, E: int, n: int, mix: str,
                      device: int, aligned: bool, **kw) -> WalkPlan:
    """``planner`` (:data:`_WALK_PLANNERS`, with its keywords ``kw``) for
    ``stem``'s instantiation on ``device``."""
    info = _coop_query(stem, mix, n, False, 0, device)

    def fit(dyn):
        return _coop_query(stem, mix, n, False, dyn, device)[0]

    return planner(E, n, mix, info[4], fit, info[3], aligned=aligned, **kw)


def _walk_launch_plan(stem: str, planner, E: int, n: int, mix: str,
                      device: torch.device, staged, *, any_head=False,
                      **kw) -> WalkPlan:
    """The plan of a launch on these operands: the bulk path needs every
    stageable operand 16-byte aligned; the cp.async path copies in units
    of at least 4 bytes, so a bf16 operand off 4-byte alignment raises,
    unless the kernel reads a copy's first unit from before the operand
    (``any_head``: K5 and K7, csrc/common.cuh ``update_plan_ok``)."""
    ptrs = [t.data_ptr() for t in staged]
    if not any_head and any(a % 4 for a in ptrs):
        raise ValueError(f"{stem}: the kernel copies its operands in 4-byte "
                         "units; a bf16 operand starts off 4-byte alignment "
                         f"(data_ptr % 4 = {[a % 4 for a in ptrs]})")
    return _walk_device_plan(stem, planner, E, n, mix,
                             _device_index(device),
                             all(a % 16 == 0 for a in ptrs), **kw)


def walk_launch_info(stem: str, E: int, n: int, mix: str, device="cuda",
                     aligned: bool = True, **kw) -> tuple[WalkPlan, dict]:
    """The plan a walker (``nekbone_ax``, ``nekbone_ax_slab``,
    ``nekbone_ax_pap``, ``nekbone_ax_dots``, ``nekbone_cg_update``,
    ``nekbone_cg_update_block`` with its lane count ``b``,
    ``nekbone_sstep_update`` with its cycle length ``s`` or
    ``nekbone_pcg_update``) launches with for E elements in build ``mix`` on
    ``device``, and the instantiation it runs: ``{"registers",
    "static_smem", "sm_count"}``."""
    planner = _WALK_PLANNERS[stem]
    index = _device_index(torch.device(device))
    plan = _walk_device_plan(stem, planner, E, n, mix, index, aligned, **kw)
    info = _coop_query(stem, mix, n, False, plan.smem_bytes, index)
    return plan, {"registers": info[2], "static_smem": info[1],
                  "sm_count": info[4]}


@_build.charged
def nekbone_cheb_apply_cuda(r2, D, g3, mx, my, mz, cx, cy, cz, coef, *,
                            n: int, k: int):
    """K11: ``z = q_k(A) r`` and per-element ``r·c·z`` partials.

    Operands as :func:`repro_torch.kernels.ref.nekbone_cheb_apply_plain`.
    One cooperative launch (:func:`k11_plan` picks its variant and grid).
    The kernel allocates nothing: this wrapper hands it ``z``, the
    partials, two buffers of the unassembled ``A d`` and, in the
    device-memory variant, scratch for the recurrence's ``d`` and ``res``
    (and its running ``z`` where the storage is not A).  Builds by operand
    dtype (:data:`MIXES`): r2 and the factors in S, D and g3 in O, coef in
    A.  Returns ``(z, rtz)``: z in S and ``rtz`` of shape (E,) in A.  The
    scratch is A too, so that a bf16 build runs the whole recurrence in
    f32 and rounds z once, as the reference does.
    """
    if r2.device.type == "cpu":
        return nekbone_cheb_apply_plain(r2, D, g3, mx, my, mz, cx, cy, cz,
                                        coef, n=n, k=k)
    if k < 1:
        raise ValueError(f"nekbone_cheb_apply: k={k}, need k >= 1")
    ex, ey, ez = mx.shape[0], my.shape[0], mz.shape[0]
    E = ex * ey * ez
    n3 = n ** 3
    mix = _check("nekbone_cheb_apply", n, r2.device, r2=(r2, (E, n3)),
                 D=(D, (n, n), "O"), g3=(g3, (E, 3, n3), "O"),
                 mx=(mx, (ex, n)), my=(my, (ey, n)), mz=(mz, (ez, n)),
                 cx=(cx, (ex, n)), cy=(cy, (ey, n)), cz=(cz, (ez, n)),
                 coef=(coef, (k + 1, 2), "A"))
    acc = MIXES[mix]["A"]
    plan = _coop_device_plan("nekbone_cheb_apply", k11_plan, E, n, mix,
                             _device_index(r2.device))
    z = torch.empty_like(r2)
    # ad0, ad1; the device variant's d and res; and its running z where z
    # is not stored in A
    count = 2 if plan.resident else 4 + (r2.dtype != acc)
    scratch = torch.empty(count, E, n3, dtype=acc, device=r2.device)
    rtz = torch.empty(E, dtype=acc, device=r2.device)
    state = (0, 0) if plan.resident else (scratch[2].data_ptr(),
                                          scratch[3].data_ptr())
    zacc = scratch[4].data_ptr() if count == 5 else 0
    _build.launch(
        f"nekbone_cheb_apply_{mix}", _ARGTYPES["nekbone_cheb_apply"],
        r2.device,
        (*(t.data_ptr() for t in (r2, D, g3, mx, my, mz, cx, cy, cz, coef,
                                  z)), *state, scratch[0].data_ptr(),
         scratch[1].data_ptr(), rtz.data_ptr(), zacc, ex, ey, ez, n, k,
         int(plan.resident), plan.per_block, plan.grid))
    return z, rtz


# K12's groups need not hold more elements than keep this many threads a
# block busy (G k12_lanes).
K12_MIN_THREADS = 128
# The depth of K12's ring (csrc/nekbone_interp.cu kInterpStages): one stage,
# the next group's copy landing while the current group is contracted along
# j and k.
K12_STAGES = 1


@dataclasses.dataclass(frozen=True)
class InterpPlan:
    """One launch of K12: the elements go in ``groups`` groups of ``group``
    (the last one cut at E), one copy each; block b of ``grid`` owns the
    groups ``[b * per_block, (b + 1) * per_block)`` and walks them with
    ``threads`` = ``group`` :func:`k12_lanes` threads, while the ring
    (:data:`K12_STAGES`) in its dynamic shared memory (``smem_bytes``, with
    the group's contraction along i) takes the next group's input, copied
    by TMA bulk copies (``bulk``) or per-thread ``cp.async``.
    ``blocks_per_sm`` is the residency the grid was sized by."""
    group: int
    groups: int
    per_block: int
    grid: int
    blocks_per_sm: int
    threads: int
    smem_bytes: int
    bulk: bool

    @property
    def copy(self) -> str:
        return "bulk" if self.bulk else "cp.async"

    @property
    def launch_ints(self) -> tuple[int, ...]:
        """(group, per_block, grid, bulk): the C entry's plan."""
        return (self.group, self.per_block, self.grid, int(self.bulk))


def k12_group_align(nin: int, mix: str) -> int:
    """The least G whose input bytes (G nin^3 values in S) are a multiple of
    16: a group that is one bulk copy comes in multiples of it."""
    nbytes = nin ** 3 * MIXES[mix]["S"].itemsize
    return 16 // math.gcd(16, nbytes)


def k12_lanes(nin: int, nout: int) -> int:
    """Threads a group's element takes in K12 (csrc/nekbone_interp.cu
    ``kInterpLanes``): nout x max(nin, nout); the first nout x nout own an
    output column each, and on a restriction the others share the
    contraction along i."""
    return nout * max(nin, nout)


def k12_max_threads(nin: int, mix: str) -> int:
    """The most threads a block of K12 takes (csrc/nekbone_interp.cu
    ``kInterpMaxThreads``): 1024 where a row of nin values in A is at most
    20 bytes, else 256."""
    return 1024 if nin * MIXES[mix]["A"].itemsize <= 20 else 256


def k12_dyn_bytes(nin: int, nout: int, mix: str, group: int,
                  bulk: bool) -> int:
    """A block's dynamic shared bytes (csrc/nekbone_interp.cu
    ``interp_dyn_bytes``): the ring's :data:`K12_STAGES` stages of one
    group's input, then the group's contraction along i, G nin^2 nout
    values in A."""
    s, a = MIXES[mix]["S"].itemsize, MIXES[mix]["A"].itemsize
    return (K12_STAGES * walk_slot_bytes(group * nin ** 3 * s, bulk)
            + group * nin * nin * nout * a)


def k12_plan(E: int, nin: int, nout: int, mix: str, sm_count: int,
             blocks_per_sm, smem_per_block: int, *,
             aligned: bool = True) -> InterpPlan:
    """K12's plan for E elements from degree nin - 1 to nout - 1 in build
    ``mix``.

    ``blocks_per_sm(threads, dyn_bytes)`` is how many blocks of ``threads``
    threads an SM holds with that much dynamic shared memory each (on the
    card, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
    ``smem_per_block`` the most a block may take.  A group of G elements is
    one bulk copy where u is 16-byte aligned (``aligned``) and G, and the
    last group's count, are multiples of :func:`k12_group_align`, with G
    :func:`k12_lanes` threads within :func:`k12_max_threads`; otherwise the
    plan takes the cp.async path.  G is the count, among the multiples of
    that alignment up to the least that keeps :data:`K12_MIN_THREADS`
    threads a block busy, that keeps the most elements resident an SM
    (ties: the larger): the coarse steps take blocks of about that many
    threads where they would otherwise run blocks of 4 to 50, and a step
    whose input fills shared memory (10 -> 5 in fp64) takes small groups.
    Every block owns the least count of groups that puts the whole grid on
    the card at once (:func:`device_memory_plan`).  Raises ``ValueError``
    where the pair is no ladder step or no block fits an SM.
    """
    what = f"k12_plan ({nin}->{nout}, {mix})"
    _check_plan(what, E, sm_count, 1)
    if (nin, nout) not in INTERP_PAIRS:
        raise ValueError(f"k12_plan: ({nin}, {nout}) is not a step of the "
                         "p-multigrid ladder")
    most = k12_max_threads(nin, mix)
    per = k12_lanes(nin, nout)
    align = k12_group_align(nin, mix)
    # the least bulk group that keeps K12_MIN_THREADS busy, and its last
    # group
    top = align * max(1, -(-K12_MIN_THREADS // (align * per)))
    while top > align and top * per > most:
        top -= align
    bulk = (aligned and top * per <= most
            and (E - (-(-E // top) - 1) * top) % align == 0)
    step = align if bulk else 1
    if not bulk:
        top = max(1, min(-(-K12_MIN_THREADS // per), most // per))

    best = None
    for group in range(step, top + 1, step):
        if bulk and (E - (-(-E // group) - 1) * group) % align:
            continue
        dyn = k12_dyn_bytes(nin, nout, mix, group, bulk)
        fit = blocks_per_sm(group * per, dyn) if dyn <= smem_per_block else 0
        if fit >= 1 and (best is None or fit * group >= best[0]):
            best = (fit * group, group, fit, dyn)
    if best is None:
        raise ValueError(
            f"{what}: no block of a group of {step} or more elements fits an "
            f"SM ({smem_per_block} bytes of shared memory a block at most)")
    _, group, fit, dyn = best
    groups = -(-E // group)
    base = device_memory_plan(groups, sm_count, fit, 1, dyn)
    return InterpPlan(group, groups, base.per_block, base.grid, fit,
                      group * per, dyn, bulk)


@functools.lru_cache(maxsize=None)
def _interp_query(mix: str, nin: int, nout: int, threads: int, dyn: int,
                  device: int) -> tuple[int, ...]:
    """K12's occupancy query (csrc/nekbone_interp.cu, common.cuh
    ``coop_query``) for blocks of ``threads`` threads."""
    lib = _build.load(f"nekbone_interp_{mix}")
    fn = getattr(lib, f"nekbone_interp_query_{mix}")
    fn.argtypes = [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        err = fn(nin, nout, threads, dyn, out)
    if err != 0:
        raise RuntimeError(f"nekbone_interp: occupancy query failed with "
                           f"CUDA error {err}")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _interp_device_plan(E: int, nin: int, nout: int, mix: str, device: int,
                        aligned: bool) -> InterpPlan:
    """:func:`k12_plan` for the instantiation on ``device``."""
    info = _interp_query(mix, nin, nout, 32, 0, device)

    def fit(threads, dyn):
        return _interp_query(mix, nin, nout, threads, dyn, device)[0]

    return k12_plan(E, nin, nout, mix, info[4], fit, info[3],
                    aligned=aligned)


def nekbone_interp_plan(E: int, nin: int, nout: int, mix: str,
                        device="cuda", aligned: bool = True
                        ) -> tuple[InterpPlan, dict]:
    """The plan K12 launches with for E elements of the step nin -> nout in
    build ``mix`` on ``device``, and the instantiation it runs:
    ``{"registers", "static_smem", "sm_count"}``."""
    index = _device_index(torch.device(device))
    plan = _interp_device_plan(E, nin, nout, mix, index, aligned)
    info = _interp_query(mix, nin, nout, plan.threads, plan.smem_bytes,
                         index)
    return plan, {"registers": info[2], "static_smem": info[1],
                  "sm_count": info[4]}


def nekbone_interp_floor(plan: InterpPlan, mix: str, device="cuda") -> None:
    """An empty kernel launched on ``plan``'s grid, block size and dynamic
    shared memory, from K12's library of build ``mix``: the launch floor
    that the coarse steps are read against.  It runs on no route and is
    not counted in ``_build.LAUNCHES``."""
    lib = _build.load(f"nekbone_interp_{mix}")
    fn = getattr(lib, f"nekbone_interp_floor_{mix}")
    fn.argtypes, fn.restype = [_I, _I, _I, _P], ctypes.c_int
    device = torch.device(device)
    with torch.cuda.device(device):
        err = fn(plan.grid, plan.threads, plan.smem_bytes,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nekbone_interp_floor_{mix}: launch failed with "
                           f"CUDA error {err}")


@_build.charged
def nekbone_interp_cuda(u2, mt, *, nin: int, nout: int):
    """K12: tensor-product GLL-to-GLL interpolation, along i, then j, then k.

    ``u2``: (E, nin^3); ``mt``: (nin, nout), rows indexed by the input grid
    (``J`` restricts, ``J^T`` prolongs).  One launch of the grid
    :func:`k12_plan` sizes.  Builds by operand dtype (:data:`MIXES`): u2 in
    S, mt in O.  Returns (E, nout^3) in S.  The pair must be a step of the
    p-multigrid ladder (:data:`INTERP_PAIRS`).
    """
    if u2.device.type == "cpu":
        return nekbone_interp_plain(u2, mt, nin=nin, nout=nout)
    if (nin, nout) not in INTERP_PAIRS:
        raise ValueError(f"nekbone_interp: ({nin}, {nout}) is not a step "
                         "n -> ceil(n/2) or back of the p-multigrid ladder, "
                         "n = 3..16")
    E = u2.shape[0]
    mix = _check("nekbone_interp", nin, u2.device,
                 u2=(u2, (E, nin ** 3)), mt=(mt, (nin, nout), "O"))
    plan = _interp_device_plan(E, nin, nout, mix, _device_index(u2.device),
                               u2.data_ptr() % 16 == 0)
    v2 = torch.empty(E, nout ** 3, dtype=u2.dtype, device=u2.device)
    _launch("nekbone_interp", mix, u2.device, (u2, mt, v2),
            (E, nin, nout, *plan.launch_ints))
    return v2


# K6's lanes that share one layer sweep (csrc/nekbone_ax_slab_block.cu
# kLanes).
K6_LANES = 2


def k6_lane_groups(b: int) -> list[tuple[int, ...]]:
    """The lanes of each of K6's layer sweeps for b right-hand sides: group
    g (``blockIdx.y``) takes lanes ``K6_LANES g`` onwards, the last group of
    an odd b one lane."""
    if b < 1:
        raise ValueError(f"k6_lane_groups: b={b}")
    return [tuple(range(l0, min(l0 + K6_LANES, b)))
            for l0 in range(0, b, K6_LANES)]


@_build.charged
def nekbone_ax_slab_block_cuda(p3, r3, D, g3, mx, my, mz, beta, *, n: int):
    """K6: K4 over b right-hand sides, the lanes in pairs through one layer
    sweep (:func:`k6_lane_groups`).

    Operands as :func:`repro_torch.kernels.ref.nekbone_ax_slab_block_plain`:
    ``p3``, ``r3``: (b, E, n^3); ``beta``: (b,).  Builds by operand dtype
    (:data:`MIXES`): p3, r3 and the factors in S, D and g3 in O, beta in A.
    Returns ``(p3, w3, pap)`` with ``w3`` unassembled in S and ``pap`` of
    shape (b, E) in A; each lane is bitwise K4's on that lane.
    """
    if p3.device.type == "cpu":
        return nekbone_ax_slab_block_plain(p3, r3, D, g3, mx, my, mz, beta,
                                           n=n)
    ex, ey, ez = mx.shape[0], my.shape[0], mz.shape[0]
    E = ex * ey * ez
    n3 = n ** 3
    b = p3.shape[0]
    mix = _check("nekbone_ax_slab_block", n, p3.device,
                 p3=(p3, (b, E, n3)), r3=(r3, (b, E, n3)),
                 D=(D, (n, n), "O"), g3=(g3, (E, 3, n3), "O"),
                 mx=(mx, (ex, n)), my=(my, (ey, n)), mz=(mz, (ez, n)),
                 beta=(beta, (b,), "A"))
    p_out = torch.empty_like(p3)
    w3 = torch.empty_like(p3)
    pap = torch.empty(b, E, dtype=MIXES[mix]["A"], device=p3.device)
    _launch("nekbone_ax_slab_block", mix, p3.device,
            (p3, r3, D, g3, mx, my, mz, beta, p_out, w3, pap),
            (ex, ey, ez, n, b))
    return p_out, w3, pap


@_build.charged
def nekbone_cg_update_block_cuda(x3, p3, r3, w3, alpha, cx, cy, cz, *,
                                 n: int):
    """K7: K5 over b right-hand sides, the b E work items in one walk.

    Operands as
    :func:`repro_torch.kernels.ref.nekbone_cg_update_block_plain`: ``x3``,
    ``p3``, ``r3``, ``w3``: (b, E, n^3); ``alpha``: (b,).  One launch of
    the grid :func:`k7_plan` sizes.  Builds by operand dtype
    (:data:`MIXES`): x3 in X, p3, r3, w3 and the factors in S, alpha in A.
    Returns ``(x3, r3, rcr)`` with ``rcr`` of shape (b, E) in A; each lane
    is bitwise K5's on that lane.
    """
    if x3.device.type == "cpu":
        return nekbone_cg_update_block_plain(x3, p3, r3, w3, alpha, cx, cy,
                                             cz, n=n)
    ex, ey, ez = cx.shape[0], cy.shape[0], cz.shape[0]
    E = ex * ey * ez
    n3 = n ** 3
    b = x3.shape[0]
    mix = _check("nekbone_cg_update_block", n, x3.device,
                 x3=(x3, (b, E, n3), "X"), p3=(p3, (b, E, n3)),
                 r3=(r3, (b, E, n3)), w3=(w3, (b, E, n3)),
                 alpha=(alpha, (b,), "A"), cx=(cx, (ex, n)),
                 cy=(cy, (ey, n)), cz=(cz, (ez, n)))
    plan = _walk_launch_plan("nekbone_cg_update_block", k7_plan, E, n, mix,
                             x3.device, (x3, p3, r3, w3), any_head=True,
                             b=b)
    x_out = torch.empty_like(x3)
    r_out = torch.empty_like(r3)
    rcr = torch.empty(b, E, dtype=MIXES[mix]["A"], device=x3.device)
    _launch("nekbone_cg_update_block", mix, x3.device,
            (x3, p3, r3, w3, alpha, cx, cy, cz, x_out, r_out, rcr),
            (ex, ey, ez, n, b, *plan.launch_ints))
    return x_out, r_out, rcr


@_build.charged
def nekbone_ax_pap_cuda(p2, D, g2, mask2, *, n: int):
    """K3: ``w = mask (D^T G D p)`` with the full metric, pap partials.

    Operands as :func:`repro_torch.kernels.ref.nekbone_ax_pap_plain`:
    ``p2``, ``mask2``: (E, n^3) in S; ``D``, ``g2``: (n, n), (E, 6, n^3) in
    O (:data:`MIXES`).  Returns ``(w, pap)`` with ``w`` unassembled in S
    and ``pap`` of shape (E,) in A.  One launch of the grid :func:`k3_plan`
    sizes.
    """
    if p2.device.type == "cpu":
        return nekbone_ax_pap_plain(p2, D, g2, mask2, n=n)
    E = p2.shape[0]
    n3 = n ** 3
    mix = _check("nekbone_ax_pap", n, p2.device, p2=(p2, (E, n3)),
                 D=(D, (n, n), "O"), g2=(g2, (E, 6, n3), "O"),
                 mask2=(mask2, (E, n3)))
    plan = _walk_launch_plan("nekbone_ax_pap", k3_plan, E, n, mix,
                             p2.device, (p2, g2, mask2))
    w2 = torch.empty_like(p2)
    pap = torch.empty(E, dtype=MIXES[mix]["A"], device=p2.device)
    _launch("nekbone_ax_pap", mix, p2.device, (p2, D, g2, mask2, w2, pap),
            (E, n, *plan.launch_ints))
    return w2, pap


@_build.charged
def nekbone_ax_dots_cuda(p2, D, g2, mask2, r2, c2, *, n: int):
    """K2: K3 plus per-element ``r·c·r`` partials.

    Operands as :func:`repro_torch.kernels.ref.nekbone_ax_dots_plain`; K3's
    plan (:func:`k3_plan`), r and c read from device memory.  Builds by
    operand dtype (:data:`MIXES`): p2, mask2, r2 and c2 in S, D and g2 in
    O.  Returns ``(w, pap, rcz)`` with ``w`` unassembled in S and ``pap``
    and ``rcz`` of shape (E,) in A.
    """
    if p2.device.type == "cpu":
        return nekbone_ax_dots_plain(p2, D, g2, mask2, r2, c2, n=n)
    E = p2.shape[0]
    n3 = n ** 3
    mix = _check("nekbone_ax_dots", n, p2.device, p2=(p2, (E, n3)),
                 D=(D, (n, n), "O"), g2=(g2, (E, 6, n3), "O"),
                 mask2=(mask2, (E, n3)), r2=(r2, (E, n3)), c2=(c2, (E, n3)))
    plan = _walk_launch_plan("nekbone_ax_dots", k3_plan, E, n, mix,
                             p2.device, (p2, g2, mask2))
    w2 = torch.empty_like(p2)
    parts = torch.empty(2, E, dtype=MIXES[mix]["A"], device=p2.device)
    _launch("nekbone_ax_dots", mix, p2.device,
            (p2, D, g2, mask2, r2, c2, w2, parts[0], parts[1]),
            (E, n, *plan.launch_ints))
    return w2, parts[0], parts[1]


def _check_s(stem: str, s: int) -> None:
    if not 1 <= s <= SSTEP_MAX_S:
        raise ValueError(f"{stem}: s={s} outside the built range "
                         f"1..{SSTEP_MAX_S}")


@_build.charged
def nekbone_ax_powers_cuda(p2, r2, D, g3, mx, my, mz, cx, cy, cz, inv_theta,
                           *, n: int, s: int):
    """K8: the scaled s-step basis and per-element Gram partials.

    Operands as :func:`repro_torch.kernels.ref.nekbone_ax_powers_plain`.
    One cooperative launch (:func:`k8_plan` sizes its grid).
    The kernel allocates nothing: this wrapper hands it the basis, the Gram
    partials and four buffers of unassembled operator outputs (two per
    chain).  Builds by operand dtype (:data:`MIXES`): p2, r2 and the
    factors in S, D and g3 in O, inv_theta in A.  Returns ``(basis,
    gram)``: (E, 2s-1, n^3) in S and (E, 2s+1, 2s+1) in A; the partials are
    summed in the order of
    :func:`repro_torch.kernels.ref.sstep_gram_emulated`.  The unassembled
    outputs are A too, so that a bf16 build rounds each vector once, after
    its assembly.
    """
    if p2.device.type == "cpu":
        return nekbone_ax_powers_plain(p2, r2, D, g3, mx, my, mz, cx, cy, cz,
                                       inv_theta, n=n, s=s)
    _check_s("nekbone_ax_powers", s)
    ex, ey, ez = mx.shape[0], my.shape[0], mz.shape[0]
    E = ex * ey * ez
    n3 = n ** 3
    mix = _check("nekbone_ax_powers", n, p2.device, p2=(p2, (E, n3)),
                 r2=(r2, (E, n3)), D=(D, (n, n), "O"),
                 g3=(g3, (E, 3, n3), "O"), mx=(mx, (ex, n)),
                 my=(my, (ey, n)), mz=(mz, (ez, n)), cx=(cx, (ex, n)),
                 cy=(cy, (ey, n)), cz=(cz, (ez, n)),
                 inv_theta=(inv_theta.reshape(1), (1,), "A"))
    acc = MIXES[mix]["A"]
    plan = _coop_device_plan("nekbone_ax_powers", k8_plan, E, n, mix,
                             _device_index(p2.device), s=s)
    K = 2 * s + 1
    basis = torch.empty(E, 2 * s - 1, n3, dtype=p2.dtype, device=p2.device)
    gram = torch.empty(E, K, K, dtype=acc, device=p2.device)
    scratch = torch.empty(4, E, n3, dtype=acc, device=p2.device)
    _launch("nekbone_ax_powers", mix, p2.device,
            (p2, r2, D, g3, mx, my, mz, cx, cy, cz, inv_theta, basis, gram,
             *scratch),
            (ex, ey, ez, n, s, plan.per_block, plan.grid))
    return basis, gram


@_build.charged
def nekbone_sstep_update_cuda(x2, p2, r2, basis, coef, cx, cy, cz, *, n: int,
                              s: int):
    """K9: the s-step multi-axpy and per-element ``r·c·r`` partials.

    Operands as :func:`repro_torch.kernels.ref.nekbone_sstep_update_plain`:
    ``basis`` (E, 2s-1, n^3) from K8, ``coef`` (3, 2s+1).  One launch of
    the grid :func:`k9_plan` sizes, staging what it says.  Builds by
    operand dtype (:data:`MIXES`): x2 in X, p2, r2, the basis and the
    factors in S, coef in A.  Returns ``(x, r, p, rcr)`` with ``rcr`` of
    shape (E,) in A.
    """
    if x2.device.type == "cpu":
        return nekbone_sstep_update_plain(x2, p2, r2, basis, coef, cx, cy, cz,
                                          n=n, s=s)
    _check_s("nekbone_sstep_update", s)
    ex, ey, ez = cx.shape[0], cy.shape[0], cz.shape[0]
    E = ex * ey * ez
    n3 = n ** 3
    mix = _check("nekbone_sstep_update", n, x2.device,
                 x2=(x2, (E, n3), "X"), p2=(p2, (E, n3)), r2=(r2, (E, n3)),
                 basis=(basis, (E, 2 * s - 1, n3)),
                 coef=(coef, (3, 2 * s + 1), "A"),
                 cx=(cx, (ex, n)), cy=(cy, (ey, n)), cz=(cz, (ez, n)))
    plan = _walk_launch_plan("nekbone_sstep_update", k9_plan, E, n, mix,
                             x2.device, (x2, p2, r2, basis), any_head=True,
                             s=s)
    x_out = torch.empty_like(x2)
    r_out = torch.empty_like(r2)
    p_out = torch.empty_like(p2)
    rcr = torch.empty(E, dtype=MIXES[mix]["A"], device=x2.device)
    _launch("nekbone_sstep_update", mix, x2.device,
            (x2, p2, r2, basis, coef, cx, cy, cz, x_out, r_out, p_out, rcr),
            (ex, ey, ez, n, s, *plan.launch_ints))
    return x_out, r_out, p_out, rcr
