"""Plain PyTorch versions of every CUDA kernel in this package.

Each takes the kernel's own operands and returns its own outputs, so it is
both the CPU path of the kernel's wrapper (kernels/nekbone_ax.py,
kernels/flash_attn.py, kernels/wkv6.py) and the oracle the kernel is held
against on the card (``chip_smoke.py``).  They
are written for clarity, not speed.  Operands are upcast to the
accumulation dtype of the reference's ``_accum`` rule (f64 stays f64,
everything narrower accumulates in f32) and field outputs are rounded back
to the storage dtype.  The Nekbone kernels' plain versions take the bf16
kernels' two operand mixes (``kernels.nekbone_ax.MIXES``: bf16 vectors
with the operator and x in bf16 or in f32) and round where those kernels
and the TPU kernels do: K1's and K3's w once, after the whole operator,
K4's direction before the operator, K5's residual before ``r·c·r``.
"""
from __future__ import annotations

import torch

from repro_torch.core.ax import ax_local_fused, local_grad3, local_grad3_t
from repro_torch.core.geom import box_outer
from repro_torch.core.gs import ds_sum_local

__all__ = ["accum_dtype", "nekbone_ax_ref", "nekbone_ax_plain",
           "nekbone_ax_slab_plain", "nekbone_cg_update_plain",
           "nekbone_pcg_update_plain", "nekbone_cheb_apply_plain",
           "nekbone_interp_plain", "nekbone_ax_slab_block_plain",
           "nekbone_cg_update_block_plain", "nekbone_ax_pap_plain",
           "nekbone_ax_dots_plain", "nekbone_ax_powers_plain",
           "nekbone_sstep_update_plain", "sstep_gram_emulated",
           "attention_ref",
           "flash_attention_plain", "flash_attention_tc_emulated",
           "flash_tiles", "wkv6_ref", "wkv6_chunked", "wkv6_split_emulated"]

NEG_INF = -1e30          # the reference kernel's _NEG_INF (never -inf)
LOG2E = 1.4426950408889634


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """In-kernel accumulation dtype for a storage dtype."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def nekbone_ax_ref(u: torch.Tensor, D: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """Oracle of the local operator on natural shapes.

    u: (E, n, n, n) [e, k, j, i];  D: (n, n);  g: (E, 6, n, n, n).
    """
    return ax_local_fused(u, D, g)


def nekbone_ax_plain(u2: torch.Tensor, D: torch.Tensor, g2: torch.Tensor, *,
                     n: int) -> torch.Tensor:
    """K1: ``w = D^T G D u``.  u2: (E, n^3); g2: (E, 6, n^3) -> (E, n^3)."""
    acc = accum_dtype(u2.dtype)
    E = u2.shape[0]
    w = ax_local_fused(u2.to(acc).reshape(E, n, n, n), D.to(acc),
                       g2.to(acc).reshape(E, 6, n, n, n))
    return w.reshape(E, n ** 3).to(u2.dtype)


def _masked_ax_diag(u4, D, g, mask):
    """Masked, unassembled ``D^T diag(g) D u`` of (E, n, n, n) fields; ``g``
    is the (E, 3, n, n, n) metric diagonal."""
    wr, ws, wt = local_grad3(u4, D)
    return local_grad3_t(g[:, 0] * wr, g[:, 1] * ws, g[:, 2] * wt, D) * mask


def nekbone_ax_slab_plain(p2, r2, D, g3, mx, my, mz, beta, *, n: int):
    """K4: direction update, diagonal-metric masked Ax, pap partials.

    Args:
      p2, r2: (E, n^3) previous direction and residual; g3: (E, 3, n^3)
      metric diagonal (rr, ss, tt); mx, my, mz: (EX|EY|EZ, n) per-axis
      mask factors, whose lengths give the element grid (EX, EY, EZ),
      elements z-major; beta: one-element tensor.

    Returns ``(p, w, pap)``: the stored direction ``r + beta p2``, the masked
    *unassembled* operator output, and one ``sum(p * w)`` per element (E,).
    """
    acc = accum_dtype(p2.dtype)
    E = p2.shape[0]
    p = r2.to(acc) + beta.reshape(()).to(acc) * p2.to(acc)
    p = p.to(p2.dtype).to(acc)          # rounded through storage
    p4 = p.reshape(E, n, n, n)
    g = g3.to(acc).reshape(E, 3, n, n, n)
    mask = box_outer(mz.to(acc), my.to(acc), mx.to(acc)).reshape(E, n, n, n)
    v = _masked_ax_diag(p4, D.to(acc), g, mask)
    pap = (p4 * v).reshape(E, -1).sum(dim=1)
    return (p.to(p2.dtype).reshape(E, n ** 3),
            v.to(p2.dtype).reshape(E, n ** 3), pap)


def _assemble(w2, grid, n: int, acc, from_below=None, from_above=None):
    """``ds_sum_local`` of K4's unassembled ``w2`` in ``acc``, with a
    neighbour shard's x,y-assembled edge planes (``(EY*EX, n, n)``, in
    ``acc``) added in the z step: ``from_below`` to the ``k = 0`` face of
    the bottom element layer, ``from_above`` to the ``k = n-1`` face of the
    top one, where a single-shard sum adds its neighbour layer's value."""
    ex, ey, ez = grid
    E = w2.shape[0]
    w = ds_sum_local(w2.to(acc).reshape(E, n, n, n), grid)
    v = w.reshape(ez, ey * ex, n, n, n)
    if from_below is not None:
        v[0, :, 0] += from_below.to(acc).reshape(ey * ex, n, n)
    if from_above is not None:
        v[-1, :, -1] += from_above.to(acc).reshape(ey * ex, n, n)
    return w.reshape(E, n ** 3)


def nekbone_cg_update_plain(x2, p2, r2, w2, alpha, cx, cy, cz, *, n: int,
                            from_below=None, from_above=None):
    """K5: assemble w, both axpys, r·c·r partials over the stored r.

    Args:
      x2, p2, r2: (E, n^3); w2: (E, n^3) masked *unassembled* operator
      output (K4's); alpha: one-element tensor; cx, cy, cz: per-axis
      ``c = mask/mult`` factors, whose lengths give the element grid;
      from_below, from_above: optional (EY*EX, n, n) edge planes of the
      neighbour shards in the accumulation dtype (``_assemble``).

    Returns ``(x, r, rcr)`` with one ``sum(r * c * r)`` per element (E,).
    """
    acc = accum_dtype(x2.dtype)
    E = x2.shape[0]
    a = alpha.reshape(()).to(acc)
    grid = (cx.shape[0], cy.shape[0], cz.shape[0])
    w = _assemble(w2, grid, n, acc, from_below, from_above)
    x = x2.to(acc) + a * p2.to(acc)
    r = (r2.to(acc) - a * w).to(r2.dtype)
    c = box_outer(cz.to(acc), cy.to(acc), cx.to(acc)).reshape(E, n ** 3)
    r6 = r.to(acc)
    rcr = (r6 * c * r6).sum(dim=1)
    return x.to(x2.dtype), r, rcr


def _grid(fx, fy, fz):
    return (fx.shape[0], fy.shape[0], fz.shape[0])


def nekbone_pcg_update_plain(x2, p2, z2, w2, alpha, invd2, cx, cy, cz, *,
                             n: int, from_below=None, from_above=None):
    """K10: assemble w, ``x += alpha p``, ``z -= alpha invd w``, partials.

    Args:
      x2, p2: (E, n^3); z2: (E, n^3) the carried ``z = invd * r``; w2:
      (E, n^3) masked *unassembled* operator output (K4's); alpha:
      one-element tensor; invd2: (E, n^3) assembled ``1/diag(A)`` (1 at
      masked nodes); cx, cy, cz: per-axis ``c`` factors, whose lengths give
      the element grid; from_below, from_above: optional edge planes of
      the neighbour shards, as :func:`nekbone_cg_update_plain` takes them.

    Returns ``(x, z, rtz, rcr)``; with ``d = 1/invd`` taken after ``z`` is
    rounded to storage, ``rtz = sum(z c z d)`` (= r·c·z) and
    ``rcr = sum(z c z d d)`` (= r·c·r), one value per element (E,).
    """
    acc = accum_dtype(x2.dtype)
    E = x2.shape[0]
    a = alpha.reshape(()).to(acc)
    w = _assemble(w2, _grid(cx, cy, cz), n, acc, from_below, from_above)
    invd = invd2.to(acc)
    x = x2.to(acc) + a * p2.to(acc)
    z = (z2.to(acc) - a * (invd * w)).to(z2.dtype)
    d = 1.0 / invd
    c = box_outer(cz.to(acc), cy.to(acc), cx.to(acc)).reshape(E, n ** 3)
    z6 = z.to(acc)
    t = z6 * c * z6 * d
    return x.to(x2.dtype), z, t.sum(dim=1), (t * d).sum(dim=1)


def nekbone_cheb_apply_plain(r2, D, g3, mx, my, mz, cx, cy, cz, coef, *,
                             n: int, k: int):
    """K11: ``z = q_k(A) r`` by the Chebyshev recurrence, and r·c·z partials.

    ``d = coef[0,0] r; z = d; res = r``, then for i in 1..k:
    ``res -= gs(mask * A_loc d); d = coef[i,0] d + coef[i,1] res; z += d``.

    Args:
      r2: (E, n^3) continuous, masked; D: (n, n); g3: (E, 3, n^3) metric
      diagonal; mx, my, mz / cx, cy, cz: per-axis mask / ``c`` factors,
      whose lengths give the element grid; coef: (k+1, 2) scalars
      (core/precond.cheb_scalars).

    Returns ``(z, rtz)``: z in ``r2``'s dtype and one ``sum(r c z)`` over
    the stored z per element (E,).
    """
    acc = accum_dtype(r2.dtype)
    E = r2.shape[0]
    grid = _grid(mx, my, mz)
    D = D.to(acc)
    g = g3.to(acc).reshape(E, 3, n, n, n)
    mask = box_outer(mz.to(acc), my.to(acc), mx.to(acc)).reshape(E, n, n, n)
    coef = coef.to(acc)
    r = r2.to(acc).reshape(E, n, n, n)
    d = coef[0, 0] * r
    z = d
    res = r
    for i in range(1, k + 1):
        res = res - ds_sum_local(_masked_ax_diag(d, D, g, mask), grid)
        d = coef[i, 0] * d + coef[i, 1] * res
        z = z + d
    z = z.reshape(E, n ** 3).to(r2.dtype)
    c = box_outer(cz.to(acc), cy.to(acc), cx.to(acc)).reshape(E, n ** 3)
    rtz = (r.reshape(E, n ** 3) * c * z.to(acc)).sum(dim=1)
    return z, rtz


def nekbone_interp_plain(u2, mt, *, nin: int, nout: int):
    """K12: tensor-product GLL-to-GLL interpolation of every element.

    ``u2``: (E, nin^3) in [e, k, j, i] order; ``mt``: (nin, nout), rows
    indexed by the input grid (``J`` restricts, ``J^T`` prolongs).  The
    three contractions run along i, then j, then k, each a sum over the
    input index in ascending order of separately rounded products, as the
    kernel computes them.  Returns (E, nout^3).
    """
    acc = accum_dtype(u2.dtype)
    E = u2.shape[0]
    m = mt.to(acc)
    u = u2.to(acc).reshape(E, nin, nin, nin)
    v1 = torch.zeros(E, nin, nin, nout, dtype=acc, device=u2.device)
    for l in range(nin):                                   # along i
        v1 = v1 + u[..., l, None] * m[l]
    v2 = torch.zeros(E, nin, nout, nout, dtype=acc, device=u2.device)
    for l in range(nin):                                   # along j
        v2 = v2 + v1[:, :, l, None, :] * m[l, :, None]
    v3 = torch.zeros(E, nout, nout, nout, dtype=acc, device=u2.device)
    for l in range(nin):                                   # along k
        v3 = v3 + v2[:, l, None] * m[l, :, None, None]
    return v3.reshape(E, nout ** 3).to(u2.dtype)


def nekbone_ax_slab_block_plain(p3, r3, D, g3, mx, my, mz, beta, *, n: int):
    """K6: K4 over b right-hand sides.

    ``p3``, ``r3``: (b, E, n^3); ``beta``: (b,); the operator operands are
    K4's and shared.  Each lane is :func:`nekbone_ax_slab_plain` on that
    lane.  Returns ``(p3, w3, pap)`` with ``pap`` of shape (b, E).
    """
    lanes = [nekbone_ax_slab_plain(p3[j], r3[j], D, g3, mx, my, mz, beta[j],
                                   n=n) for j in range(p3.shape[0])]
    return tuple(torch.stack(t) for t in zip(*lanes))


def nekbone_cg_update_block_plain(x3, p3, r3, w3, alpha, cx, cy, cz, *,
                                  n: int):
    """K7: K5 over b right-hand sides.

    ``x3``, ``p3``, ``r3``, ``w3``: (b, E, n^3); ``alpha``: (b,); the
    factors are K5's and shared.  Each lane is
    :func:`nekbone_cg_update_plain` on that lane.  Returns ``(x3, r3, rcr)``
    with ``rcr`` of shape (b, E).
    """
    lanes = [nekbone_cg_update_plain(x3[j], p3[j], r3[j], w3[j], alpha[j],
                                     cx, cy, cz, n=n)
             for j in range(x3.shape[0])]
    return tuple(torch.stack(t) for t in zip(*lanes))


def nekbone_ax_pap_plain(p2, D, g2, mask2, *, n: int):
    """K3: masked full-metric Ax and per-element ``p·w`` partials.

    ``p2``, ``mask2``: (E, n^3); ``g2``: (E, 6, n^3) metric; ``D``: (n, n).
    Returns ``(w, pap)``: the masked *unassembled* operator output and one
    ``sum(p * w)`` per element (E,), taken before ``w`` is rounded to
    storage, as the reference does.
    """
    acc = accum_dtype(p2.dtype)
    E = p2.shape[0]
    p = p2.to(acc)
    w = ax_local_fused(p.reshape(E, n, n, n), D.to(acc),
                       g2.to(acc).reshape(E, 6, n, n, n)).reshape(E, n ** 3)
    w = w * mask2.to(acc)
    return w.to(p2.dtype), (p * w).sum(dim=1)


def nekbone_ax_dots_plain(p2, D, g2, mask2, r2, c2, *, n: int):
    """K2: K3 plus per-element ``r·c·r`` partials (``r2``, ``c2``: (E, n^3)).

    Returns ``(w, pap, rcz)``.
    """
    acc = accum_dtype(p2.dtype)
    w, pap = nekbone_ax_pap_plain(p2, D, g2, mask2, n=n)
    r = r2.to(acc)
    return w, pap, (r * c2.to(acc) * r).sum(dim=1)


def nekbone_ax_powers_plain(p2, r2, D, g3, mx, my, mz, cx, cy, cz, inv_theta,
                            *, n: int, s: int):
    """K8: the scaled s-step basis and its per-element Gram partials.

    ``A' v = inv_theta * gs(mask * A_loc v)`` (mask, then assemble, then
    scale, the reference's order), chained s times from ``p2`` and s - 1
    times from ``r2``; each vector is rounded through storage before it is
    applied again and before the Gram.

    Args:
      p2, r2: (E, n^3) continuous, masked; D: (n, n); g3: (E, 3, n^3)
      metric diagonal; mx, my, mz / cx, cy, cz: per-axis mask / ``c``
      factors, whose lengths give the element grid; inv_theta: one-element
      tensor ``1/theta``.

    Returns ``(basis, gram)``: basis (E, 2s-1, n^3) holding ``[A'p..A'^s p,
    A'r..A'^{s-1} r]`` and gram (E, 2s+1, 2s+1) with
    ``gram[e, a, b] = sum(V_a * c * V_b)`` over element e.
    """
    acc = accum_dtype(p2.dtype)
    E = p2.shape[0]
    grid = _grid(mx, my, mz)
    D = D.to(acc)
    g = g3.to(acc).reshape(E, 3, n, n, n)
    mask = box_outer(mz.to(acc), my.to(acc), mx.to(acc)).reshape(E, n, n, n)
    ith = inv_theta.reshape(()).to(acc)

    def chain(v, napps):
        out = []
        for _ in range(napps):
            v = ds_sum_local(_masked_ax_diag(v, D, g, mask), grid) * ith
            v = v.to(p2.dtype).to(acc)     # rounded through storage
            out.append(v)
        return out

    p = p2.to(acc).reshape(E, n, n, n)
    r = r2.to(acc).reshape(E, n, n, n)
    new = chain(p, s) + chain(r, s - 1)
    basis = torch.stack(new, dim=1).reshape(E, 2 * s - 1, n ** 3)
    V = torch.stack([p] + new[:s] + [r] + new[s:], dim=1).reshape(
        E, 2 * s + 1, n ** 3)
    c = box_outer(cz.to(acc), cy.to(acc), cx.to(acc)).reshape(E, 1, n ** 3)
    gram = torch.einsum("eal,ebl->eab", V * c, V)
    return basis.to(p2.dtype), gram


def sstep_gram_emulated(p2, r2, basis, cx, cy, cz, *, n: int, s: int):
    """K8's per-element Gram partials in the CUDA kernel's order of terms.

    ``V = [p, basis[:, :s], r, basis[:, s:]]`` as K8 orders it; for each
    pair a <= b, element and row j of a layer, the kernel's thread adds
    ``(V_a * c) * V_b`` of the row's nodes, the layers k = 0..n-1 in order
    and each layer's nodes i = 0..n-1 in order, from 0; then the n row sums
    are added in order.  Every product and sum is rounded on its own (no
    contraction), as the kernel's ``mul_rn`` and ``add_rn`` are, so on the
    card this matches the kernel bitwise.  ``p2``, ``r2``: (E, n^3);
    ``basis``: (E, 2s-1, n^3).  Returns (E, 2s+1, 2s+1), symmetric.
    """
    E = p2.shape[0]
    K = 2 * s + 1
    V = torch.stack([p2] + [basis[:, m] for m in range(s)] + [r2]
                    + [basis[:, s + m] for m in range(s - 1)],
                    dim=1).reshape(E, K, n, n, n)
    c = box_outer(cz, cy, cx).reshape(E, 1, n, n, n)
    a, b = torch.triu_indices(K, K)
    terms = (V * c)[:, a] * V[:, b]          # (E, pairs, k, j, i)
    # each row j's terms, layer-major: (E, pairs, j, k * i)
    terms = terms.permute(0, 1, 3, 2, 4).reshape(E, len(a), n, n * n)
    rows = torch.zeros_like(terms[..., 0])
    for t in range(n * n):
        rows = rows + terms[..., t]
    total = rows[..., 0]
    for j in range(1, n):
        total = total + rows[..., j]
    gram = torch.empty(E, K, K, dtype=p2.dtype, device=p2.device)
    gram[:, a, b] = total
    gram[:, b, a] = total
    return gram


def nekbone_sstep_update_plain(x2, p2, r2, basis, coef, cx, cy, cz, *,
                               n: int, s: int):
    """K9: ``x += V coef[0]``, ``r = V coef[1]``, ``p = V coef[2]`` and the
    per-element ``r·c·r`` partials over the stored r.

    ``x2``, ``p2``, ``r2``: (E, n^3); ``basis``: (E, 2s-1, n^3) from K8;
    ``coef``: (3, 2s+1).  The terms are added in ``V``'s column order, x
    from the old x and r, p from zero, each product and sum rounded, as the
    reference and the kernel do.  Returns ``(x, r, p, rcr)``.
    """
    acc = accum_dtype(x2.dtype)
    E = x2.shape[0]
    coef = coef.to(acc)
    b = basis.to(acc)
    # V's column order (K8's): p, A'p..A'^s p, r, A'r..A'^{s-1} r
    terms = ([p2.to(acc)] + [b[:, m] for m in range(s)] + [r2.to(acc)]
             + [b[:, s + m] for m in range(s - 1)])
    xacc = x2.to(acc)
    racc = torch.zeros_like(xacc)
    pacc = torch.zeros_like(xacc)
    for k, v in enumerate(terms):
        xacc = xacc + coef[0, k] * v
        racc = racc + coef[1, k] * v
        pacc = pacc + coef[2, k] * v
    r = racc.to(r2.dtype)
    c = box_outer(cz.to(acc), cy.to(acc), cx.to(acc)).reshape(E, n ** 3)
    r6 = r.to(acc)
    return (xacc.to(x2.dtype), r, pacc.to(p2.dtype),
            (r6 * c * r6).sum(dim=1))


def attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None,
                  window: int | None = None, softcap: float | None = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Naive attention oracle with GQA / sliding window / logit softcap
    (the reference's ``kernels/ref.attention_ref``, the ``naive`` impl).

    q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d); Hq % Hkv == 0.  Masked
    scores are -inf, so a row with no valid key is NaN here; K13 and
    :func:`flash_attention_plain` give 0 there.
    """
    B, Hq, Sq, d = q.shape
    group = Hq // k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk).float() * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = _attn_mask(Sq, k.shape[2], causal, window, q_offset, q.device)
    s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv.float()).to(q.dtype)


def _attn_mask(Sq, Skv, causal, window, q_offset, device):
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def flash_attention_plain(q, k, v, *, causal: bool, scale: float,
                          window: int | None, softcap: float | None,
                          q_offset: int) -> torch.Tensor:
    """K13: the function of the reference's flash kernel, whole rows at once.

    q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d) -> (B, Hq, Sq, d) in q's
    dtype, computed in f32 (f64 for f64 inputs).  Masked scores are -1e30
    and their p is zeroed, as in the kernel, so a row with no valid key
    gives 0, not NaN.
    """
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    acc = accum_dtype(q.dtype)
    qg = q.to(acc).reshape(B, Hkv, Hq // Hkv, Sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(acc)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = _attn_mask(Sq, Skv, causal, window, q_offset, q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(acc)) \
        / torch.where(l == 0.0, 1.0, l)
    return o.reshape(B, Hq, Sq, d).to(q.dtype)


def flash_tiles(q0: int, block_q: int, block_k: int, *, Sq: int, Skv: int,
                causal: bool, window: int | None, q_offset: int):
    """The key tiles that the bf16 K13 visits for the query tile of rows
    q0 .. q0 + block_q - 1, as ``[(first key, needs the per-element
    mask)]``.

    Tiles wholly outside every valid row's causal band or window are
    skipped (they leave m, l and the accumulator unchanged: p = 0,
    correction 1).  A visited tile is masked element by element only if it
    crosses Skv, the diagonal of its first row or the window's edge of its
    last valid row; on every other tile each pair is valid for every row.
    """
    qlo = q_offset + q0
    qhi = q_offset + min(q0 + block_q, Sq) - 1
    khi = min(Skv, qhi + 1) if causal else Skv
    klo = max(0, min(qlo - window + 1, khi)) if window is not None else 0
    return [(kt, kt + block_k > Skv
             or (causal and kt + block_k - 1 > qlo)
             or (window is not None and qhi - kt >= window))
            for kt in range(klo // block_k * block_k, khi, block_k)]


def flash_attention_tc_emulated(q, k, v, *, causal: bool, scale: float,
                                window: int | None, softcap: float | None,
                                q_offset: int, block_k: int = 64,
                                split_p: bool = True) -> torch.Tensor:
    """The arithmetic of the bf16 K13 (``csrc/flash_attn.cu``,
    ``flash_attn_tc_kernel``), tile by tile, in torch.

    Query tiles of 64 rows (the kernel's block) walk the key tiles of
    :func:`flash_tiles`, ``block_k`` keys each; scores are products of
    bf16 operands summed in f32, scaled, soft-capped and taken to log2
    units (``x = cap log2(e) tanh(s scale / cap)`` or ``s scale
    log2(e)``), and -inf where the kernel masks; the online softmax runs
    on ``exp2`` from a running max starting at -1e30, so masked p is
    exactly 0; P·V takes P as the two bf16 terms ``p_hi = bf16(p)``,
    ``p_lo = bf16(p - p_hi)`` (``split_p``) or as ``bf16(p)`` once, against
    bf16 V, summed in f32; l = 0 is read as 1.  Same signature and result
    shape as :func:`flash_attention_plain`, in q's dtype.
    """
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    bf = torch.bfloat16
    qg = q.to(bf).float().reshape(B, Hkv, Hq // Hkv, Sq, d)
    kf, vf = k.to(bf).float()[:, :, None], v.to(bf).float()[:, :, None]
    out = torch.empty((B, Hkv, Hq // Hkv, Sq, d), dtype=torch.float32,
                      device=q.device)
    block_q = 64
    pre = scale / softcap if softcap is not None else scale * LOG2E
    mask = _attn_mask(Sq, Skv, causal, window, q_offset, q.device)
    for q0 in range(0, Sq, block_q):
        qt = qg[..., q0:q0 + block_q, :]
        m = torch.full((*qt.shape[:-1], 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        for kt, masked in flash_tiles(q0, block_q, block_k, Sq=Sq, Skv=Skv,
                                      causal=causal, window=window,
                                      q_offset=q_offset):
            kk, vv = kf[..., kt:kt + block_k, :], vf[..., kt:kt + block_k, :]
            s = (qt @ kk.transpose(-1, -2)) * pre
            if softcap is not None:
                s = (softcap * LOG2E) * torch.tanh(s)
            if masked:
                s = torch.where(mask[q0:q0 + block_q, kt:kt + block_k], s,
                                float("-inf"))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp2(s - m_new)
            corr = torch.exp2(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            p_hi = p.to(bf).float()
            pv = p_hi @ vv
            if split_p:
                pv = pv + (p - p_hi).to(bf).float() @ vv
            acc = acc * corr + pv
            m = m_new
        out[..., q0:q0 + block_q, :] = acc / torch.where(l == 0.0, 1.0, l)
    return out.reshape(B, Hq, Sq, d).to(q.dtype)


def wkv6_ref(r, k, v, w, u, *, initial_state=None,
             return_state: bool = False):
    """K14: the RWKV6 (Finch) recurrence, one time step at a time.

    Shapes: r, k, v, w: (B, H, T, d); u: (H, d).  Per head, with state
    S in R^{d_k x d_v}::

        o_t = S_{t-1}^T r_t + (r_t . (u * k_t)) v_t
        S_t = diag(w_t) S_{t-1} + k_t v_t^T

    r, k and v are upcast to f32 first, as the TPU kernel does (the
    reference's oracle forms ``k v^T`` in the input dtype; the two agree in
    f32); f64 inputs are computed in f64.  Returns o in r's dtype and, with
    ``return_state``, the state (f32, or f64 for f64 inputs).
    """
    B, H, T, d = r.shape
    f32 = accum_dtype(r.dtype)
    S = (torch.zeros((B, H, d, d), dtype=f32, device=r.device)
         if initial_state is None else initial_state.to(f32))
    rf, kf, vf, wf = (x.to(f32) for x in (r, k, v, w))
    uf = u.to(f32)[None]
    outs = []
    for t in range(T):
        rt, kt, vt, wt = rf[:, :, t], kf[:, :, t], vf[:, :, t], wf[:, :, t]
        out = torch.einsum("bhkv,bhk->bhv", S, rt)
        bonus = torch.einsum("bhk,bhk->bh", rt, uf * kt)
        outs.append(out + bonus[..., None] * vt)
        S = wt[..., :, None] * S + torch.einsum("bhk,bhv->bhkv", kt, vt)
    o = torch.stack(outs, dim=2).to(r.dtype)
    return (o, S) if return_state else o


def wkv6_split_emulated(r, k, v, w, u, *, col_tile: int, row_groups: int,
                        initial_state=None, return_state: bool = False):
    """K14's arithmetic (csrc/wkv6.cu) in float32 torch: the same function
    as :func:`wkv6_ref`, with the sums grouped as the kernel groups them.

    The value columns are split into tiles of ``col_tile`` and each tile
    computed on its own (a column needs only its own v); within a tile the
    key rows are split into ``row_groups`` groups of d / row_groups rows.
    Per step, each group forms its partials ``sum_{i in g} r_t[i] S[i][j]``
    and ``sum_{i in g} r_t[i] (u[i] k_t[i])``; both are summed over the
    groups in the order g = 0, 1, .., and ``o_t[j]`` is the first sum plus
    the second times ``v_t[j]``.  (The kernel forms each partial as fused
    multiply-adds in ascending i; torch rounds each product, so the two
    agree to float32 round-off, not bitwise.)
    """
    B, H, T, d = r.shape
    if d % col_tile or d % row_groups:
        raise ValueError(f"wkv6_split_emulated: d={d} is not a multiple of "
                         f"col_tile={col_tile} and row_groups={row_groups}")
    rows = d // row_groups
    f32 = torch.float32
    S = (torch.zeros((B, H, d, d), dtype=f32, device=r.device)
         if initial_state is None else initial_state.to(f32))
    rf, kf, vf, wf = (x.to(f32) for x in (r, k, v, w))
    uf = u.to(f32)[None]
    outs = []
    for t in range(T):
        rt, kt, vt, wt = rf[:, :, t], kf[:, :, t], vf[:, :, t], wf[:, :, t]
        ruk = rt * (uf * kt)
        bonus = ruk[..., :rows].sum(-1, keepdim=True)
        for g0 in range(rows, d, rows):
            bonus = bonus + ruk[..., g0:g0 + rows].sum(-1, keepdim=True)
        tiles = []
        for j0 in range(0, d, col_tile):
            cols = slice(j0, j0 + col_tile)
            acc = None
            for g0 in range(0, d, rows):
                part = torch.einsum("bhi,bhic->bhc", rt[..., g0:g0 + rows],
                                    S[:, :, g0:g0 + rows, cols])
                acc = part if acc is None else acc + part
            tiles.append(acc + bonus * vt[..., cols])
        outs.append(torch.cat(tiles, dim=-1))
        S = wt[..., :, None] * S + kt[..., :, None] * vt[..., None, :]
    o = torch.stack(outs, dim=2).to(r.dtype)
    return (o, S) if return_state else o


def wkv6_chunked(r, k, v, w, u, *, initial_state=None, chunk: int = 16,
                 return_state: bool = False):
    """The chunked-parallel WKV6 form (the reference's training path and the
    TPU kernel's ``chunked`` body): per chunk of c steps three matmuls and a
    masked (c, c) correlation, with cumulative decay products.  Same
    function as :func:`wkv6_ref`, and differentiable (the reference's
    training gradient); c is the largest divisor of T not above ``chunk``.
    Computed in f32 (f64 for f64 inputs).
    """
    B, H, T, d = r.shape
    c = min(chunk, T)
    while T % c:
        c -= 1
    f32 = accum_dtype(r.dtype)
    S = (torch.zeros((B, H, d, d), dtype=f32, device=r.device)
         if initial_state is None else initial_state.to(f32))
    uu = u.to(f32)[None, :, None, :]                  # (1, H, 1, d)
    strict = torch.tril(torch.ones(c, c, dtype=torch.bool, device=r.device),
                        diagonal=-1)
    eye = torch.eye(c, dtype=f32, device=r.device)
    outs = []
    for t0 in range(0, T, c):
        rb, kb, vb, wb = (x[:, :, t0:t0 + c].to(f32) for x in (r, k, v, w))
        logw = torch.log(wb)
        cum = torch.cumsum(logw, dim=2)
        p_incl = torch.exp(cum)
        p_excl = torch.exp(cum - logw)
        r_t = rb * p_excl
        k_t = kb * torch.exp(-cum)
        A = torch.einsum("bhtd,bhsd->bhts", r_t, k_t)
        A = torch.where(strict, A, 0.0)
        bonus = torch.einsum("bhtd,bhtd->bht", rb, uu * kb)
        A = A + torch.einsum("bht,ts->bhts", bonus, eye)
        O = torch.einsum("bhtd,bhdv->bhtv", r_t, S)
        outs.append(O + torch.einsum("bhts,bhsv->bhtv", A, vb))
        S = p_incl[:, :, -1][..., :, None] * (
            S + torch.einsum("bhsd,bhsv->bhdv", k_t, vb))
    o = torch.cat(outs, dim=2).to(r.dtype)
    return (o, S) if return_state else o


def wkv6_chunked_batched(r, k, v, w, u, *, initial_state=None,
                         chunk: int = 16, return_state: bool = False):
    """:func:`wkv6_chunked`'s products batched over its chunks, for meta
    tensors (the dry run, where a Python loop of T / chunk steps a layer
    costs minutes): the same dot products on the same shapes, so the same
    FLOPs forward and backward, with each chunk's incoming state a
    stand-in that depends on the chunk's inputs, as the chained state does
    (meta tensors hold no values: the chain between chunks carries none).
    Not a function of the inputs' values; shapes and dtypes only."""
    B, H, T, d = r.shape
    c = min(chunk, T)
    while T % c:
        c -= 1
    n = T // c
    f32 = accum_dtype(r.dtype)
    S0 = (torch.zeros((B, H, d, d), dtype=f32, device=r.device)
          if initial_state is None else initial_state.to(f32))
    uu = u.to(f32)[None, :, None, None, :]
    strict = torch.tril(torch.ones(c, c, dtype=torch.bool, device=r.device),
                        diagonal=-1)
    eye = torch.eye(c, dtype=f32, device=r.device)
    rb, kb, vb, wb = (x.to(f32).reshape(B, H, n, c, d) for x in (r, k, v, w))
    logw = torch.log(wb)
    cum = torch.cumsum(logw, dim=3)
    p_incl = torch.exp(cum)
    p_excl = torch.exp(cum - logw)
    r_t = rb * p_excl
    k_t = kb * torch.exp(-cum)
    A = torch.einsum("bhntd,bhnsd->bhnts", r_t, k_t)
    A = torch.where(strict, A, 0.0)
    bonus = torch.einsum("bhntd,bhntd->bhnt", rb, uu * kb)
    A = A + torch.einsum("bhnt,ts->bhnts", bonus, eye)
    upd = torch.einsum("bhnsd,bhnsv->bhndv", k_t, vb)
    # the state entering chunk i > 0: a stand-in made of chunk i - 1's
    # update; chunk 0 takes the initial state, as the chained form does
    S_in = S0[:, :, None] + upd[:, :, :-1]
    O = torch.cat([torch.einsum("bhtd,bhdv->bhtv", r_t[:, :, 0], S0)[:, :,
                                                                       None],
                   torch.einsum("bhntd,bhndv->bhntv", r_t[:, :, 1:], S_in)],
                  dim=2)
    o = (O + torch.einsum("bhnts,bhnsv->bhntv", A, vb)).reshape(B, H, T, d)
    last = S_in[:, :, -1] if n > 1 else S0
    S = p_incl[:, :, -1, -1][..., :, None] * (last + upd[:, :, -1])
    o = o.to(r.dtype)
    return (o, S) if return_state else o
