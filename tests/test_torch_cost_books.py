"""Port: the cost books (``core/cost.py``) — every public name of the
reference's module is in the port, and the 19 names this port added, with
``multi_rhs_streams``' ``sstep_v3`` branch, give exactly the reference's
values across the parameters the reference's ``tests/test_cost_model.py``
uses (the books are pure arithmetic: the same operations in the same
order, so equality is exact)."""
import itertools

import pytest

import repro.core.cost as ref
import repro_torch.core.cost as port

NEW_NAMES = ("bytes_per_dof_iter", "pipeline_flops_per_dof",
             "pipeline_intensity", "roofline_gflops", "fused_v2_intensity",
             "PIPELINE_STREAMS", "streams_per_rhs", "MULTI_RHS_BATCHES",
             "multi_rhs_halo_streams", "pmg_effective_streams",
             "pmg_halo_streams", "sstep_effective_streams",
             "cheb_effective_streams", "cheb_halo_streams",
             "cheb_flops_per_dof", "fused_v2_plane_streams",
             "cheb_collective_streams", "sstep_collective_streams",
             "v2_plane_collective_streams")
RUNGS = tuple(ref.PIPELINE_STREAMS)
POLICIES = ("f64", "f32", "bf16", "f32_ir", "bf16_ir")


def test_every_reference_name_is_ported():
    assert len(NEW_NAMES) == 19
    assert set(ref.__all__) <= set(port.__all__)
    for name in NEW_NAMES:
        assert name in port.__all__ and hasattr(port, name), name


def test_constant_tables_equal_reference():
    assert port.PIPELINE_STREAMS == ref.PIPELINE_STREAMS
    assert port.MULTI_RHS_BATCHES == ref.MULTI_RHS_BATCHES


def _calls():
    """(name, args, kwargs) over the reference tests' parameters."""
    out = []
    for n, item in itertools.product((3, 5, 10), (8, 4, 2)):
        out += [("fused_v2_intensity", (n, item), {}),
                ("roofline_gflops", (720.0, n, item), {}),
                ("roofline_gflops", (900.0, n, item), {})]
    for n, sz in itertools.product((5, 10), (1, 2, 4, 8)):
        out += [("fused_v2_plane_streams", (n, sz), {})]
    for s, ez in itertools.product((1, 2, 4, 8), (4, 8)):
        out += [("sstep_collective_streams", (s, ez), {}),
                ("cheb_collective_streams", (s, ez), {}),
                ("v2_plane_collective_streams", (10, ez), {})]
    for k, sz in itertools.product((1, 2, 3, 4), (2, 4, 8)):
        out += [("cheb_halo_streams", (k, sz), {}),
                ("cheb_effective_streams", (k, sz), {}),
                ("cheb_effective_streams", (k, sz),
                 dict(ndev=8, ez=32, n=10)),
                ("sstep_effective_streams", (k, sz), {}),
                ("sstep_effective_streams", (k, sz), dict(ndev=1, ez=32)),
                ("sstep_effective_streams", (k, sz), dict(ndev=8, ez=32))]
    for n, k in itertools.product((3, 5, 10), (1, 2, 3, 4)):
        out += [("cheb_flops_per_dof", (n, k), {}),
                ("pmg_halo_streams", (n, k, 4), {}),
                ("pmg_effective_streams", (n, k, 4), {}),
                ("pmg_effective_streams", (n, k, 2), dict(coarse_iters=6))]
    for b, s, sz in itertools.product((1, 2, 3, 4, 8, 10 ** 6), (1, 2, 4),
                                      (4,)):
        out += [("streams_per_rhs", (b, "fused_v2"), {}),
                ("streams_per_rhs", (b, "sstep_v3"), dict(s=s)),
                ("multi_rhs_streams", (b, "sstep_v3"), dict(s=s)),
                ("multi_rhs_streams", (b,), {}),
                ("multi_rhs_halo_streams", (b, s, sz), {})]
    for rung, pol in itertools.product(RUNGS, POLICIES):
        out += [("bytes_per_dof_iter", (rung, pol), {}),
                ("bytes_per_dof_iter", (rung, pol), dict(exact=True)),
                ("bytes_per_dof_iter", (rung, pol),
                 dict(exact=True, n=5, sz=2, s=2, k=2)),
                ("pipeline_flops_per_dof", (10, rung), {}),
                ("pipeline_flops_per_dof", (5, rung), {}),
                ("pipeline_intensity", (10, rung, pol), {})]
    for rung in ("sstep_v3", "fused_v2", "fused_v2_jacobi", "fused_v2_cheb"):
        out += [("bytes_per_dof_iter", (rung, "f32"),
                 dict(exact=True, ndev=8, ez=32)),
                ("bytes_per_dof_iter", (rung, "f32"),
                 dict(exact=True, ndev=1, ez=32))]
    for s in (1, 2, 4, 8):
        out += [("bytes_per_dof_iter", ("sstep_v3", "f64"), dict(s=s)),
                ("bytes_per_dof_iter", ("sstep_v3_rhs4", "f32"),
                 dict(s=s, exact=True))]
    return out


CALLS = _calls()


@pytest.mark.parametrize("name", sorted({c[0] for c in CALLS}))
def test_book_equals_reference(name):
    calls = [c for c in CALLS if c[0] == name]
    assert calls
    for _, args, kw in calls:
        want = getattr(ref, name)(*args, **kw)
        got = getattr(port, name)(*args, **kw)
        assert got == want, (name, args, kw, got, want)


@pytest.mark.parametrize("name,args,kw,exc", [
    ("sstep_effective_streams", (4, 4), dict(ndev=8), "needs the global EZ"),
    ("sstep_effective_streams", (4, 4), dict(ndev=8, ez=30),
     "not divisible"),
    ("bytes_per_dof_iter", ("eq2", "f32"), dict(exact=True, ndev=8, ez=32),
     "no sharded variant"),
    ("bytes_per_dof_iter", ("fused_v1", "f32"),
     dict(exact=True, ndev=8, ez=32), "no sharded variant"),
    ("bytes_per_dof_iter", ("sstep_v3", "f32"), dict(ndev=8, ez=32),
     "exact=True"),
    ("multi_rhs_streams", (0,), {}, "RHS batch"),
    ("multi_rhs_streams", (2, "eq2"), {}, "no multi-RHS books"),
    ("pipeline_flops_per_dof", (10, "nope"), {}, "unknown pipeline"),
])
def test_book_rejects_like_reference(name, args, kw, exc):
    for mod in (ref, port):
        with pytest.raises(ValueError, match=exc):
            getattr(mod, name)(*args, **kw)


def test_sstep_v3_branch_values():
    """The branch the port dropped until now: the s=4 rung at b=1, and the
    b=8 acceptance point of the reference's books."""
    assert port.streams_per_rhs(1, "sstep_v3") == 6.25
    assert port.streams_per_rhs(8, "sstep_v3") == 5.59375
    assert port.multi_rhs_streams(1, "sstep_v3", s=1) == \
        port.multi_rhs_streams(1, "fused_v2")
