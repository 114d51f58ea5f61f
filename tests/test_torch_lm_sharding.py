"""Port parity, the LM's sharding: the rules, meshes and specs, and the
sequence-sharded attention, context-parallel decode and expert-parallel
MoE over ``torch.distributed`` with gloo on the CPU, against the JAX
reference on one device.

The specs are held to the reference's on stand-in meshes (the reference's
``AbstractMesh`` under ``use_abstract_mesh``, the port's ``AbstractMesh``
under ``use_mesh``) of (data 16, model 16), (pod 2, data 16, model 16) and
(data 2, model 2).  The sharded branches run in gloo worlds of 2 and 4
child processes that run only the port (the harness of
``tests/test_torch_distributed_gs.py``: this file runs itself as the
child, a 60 s timeout on ``init_process_group`` and a 120 s timeout on the
children); the parent computes the reference in-process, in f32.

Bars (``tests/distributed_checks.py``'s): attention and decode outputs to
1e-4, the decode cache to 1e-6, the MoE to 1e-5, the served slice's logits
to 1e-4 of max |logit|.  The slice is the reduced hymba config with 5
heads and 1 KV head: the reduced config's 8 and 4 divide a model axis of
2, so neither sharded branch would fire; 5 and 1, like the full config's
25 and 5, divide it in neither.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve()
sys.path.insert(0, str(HERE.parent))

from test_torch_distributed_gs import (Worlds, child_main,  # noqa: E402
                                       load)

ATTN = dict(B=2, H=5, Hkv=5, S=64, d=16, seed=5)
ATTN_GQA = dict(B=1, H=15, Hkv=5, S=64, d=16, seed=7)
# None: the gathered path; 8 < S_loc: the halo path; 40 >= S_loc: gathered
# with the window mask
WINDOWS = [None, 8, 40]
SLICE_PROMPT, SLICE_STEPS, SLICE_B = 40, 4, 2
# (H, Hkv) of the decode checks: KV heads that the model axis does not
# divide (the reference check's 6 and 2 over a model axis of 4), and the
# reference's again where the cache is context-parallel over 'data'
DECODE_HEADS = {"decode@2": [5, 1], "decode@4": [6, 2],
                "decode@4cp": [6, 2]}


def _np(t):
    return t.detach().to("cpu").numpy()


def _counts(log) -> np.ndarray:
    return np.array(json.dumps(log.counts))


@dataclasses.dataclass(frozen=True)
class DecodeCfg:
    """The reference check's decode layer (``distributed_checks.py``)."""

    d_model: int = 32
    n_heads: int = 6
    n_kv_heads: int = 2
    head_dim: int = 8
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float | None = None
    pos_emb: str = "rope"
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def hd(self) -> int:
        return self.head_dim


def _decode_layer(heads, seed=0):
    """The port's decode layer with ``heads`` = (H, Hkv) and numpy weights
    from ``seed``, and the weights by name."""
    import torch

    from repro_torch.models import attention as A

    cfg = DecodeCfg(n_heads=heads[0], n_kv_heads=heads[1])
    p = A.init_attention(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(seed)
    arrays = {}
    with torch.no_grad():
        for name, t in p.named_parameters():
            arrays[name] = (rng.normal(size=tuple(t.shape)) * 0.2).astype(
                np.float32)
            t.copy_(torch.as_tensor(arrays[name]))
    return cfg, p, arrays


def _decode_inputs(Hkv):
    rng = np.random.default_rng(6)
    B, S = 2, 32
    x = rng.normal(size=(B, 1, 32)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, 8)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, 8)).astype(np.float32)
    return x, k, v


def _slice_cfg(cfg):
    return dataclasses.replace(cfg.reduced(), n_heads=5, n_kv_heads=1)


def _moe_module():
    import torch
    from torch import nn

    from repro_torch.configs import ARCHS
    from repro_torch.models import moe as MO

    cfg = ARCHS["qwen3-moe-30b-a3b"].reduced()
    holder = nn.Module()
    holder.moe = MO.init_moe(torch.Generator().manual_seed(0), cfg)
    return cfg, holder


def _moe_x(cfg):
    return np.random.default_rng(1).normal(
        size=(4, 16, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# child checks: the port alone (no jax, no repro)
# ---------------------------------------------------------------------------

def c_mesh(world, model_parallel):
    """The mesh's layout, and constrain on a plain tensor and a DTensor."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh_for

    mesh = make_mesh_for(world, model_parallel=model_parallel)
    t = torch.arange(12.0).reshape(3, 4)
    with SH.use_mesh(mesh):
        same = SH.constrain(t, SH.P("data", "model"))
        d = distribute_tensor(torch.arange(32.0).reshape(4, 8), mesh,
                              [Replicate(), Replicate()])
        e = SH.constrain(d, SH.P(("pod", "data"), "model"))
        size = SH.RULES._size("model")
    return {"shape": np.array(mesh.mesh.shape),
            "names": np.array(list(mesh.mesh_dim_names)),
            "same_ptr": np.array(same is t and same.data_ptr()
                                 == t.data_ptr()),
            "placements": np.array([p == Shard(1) for p in e.placements]
                                   + [p == Shard(0) for p in e.placements]),
            "local": _np(e.to_local()), "size": np.array(size)}


def c_seq_attn(B, H, Hkv, S, d, seed, windows):
    """_seq_sharded_chunked's slices on (data 1, model 2), one per
    window, with the collectives each issued."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import attention as A

    mesh = make_mesh_for(2, model_parallel=2)
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
               for s in ((B, H, S, d), (B, Hkv, S, d), (B, Hkv, S, d)))
    out = {}
    with SH.use_mesh(mesh):
        for w in windows:
            with SH.collective_log() as log:
                o = A._seq_sharded_chunked(q, k, v, causal=True, window=w,
                                           cap=None, scale=d ** -0.5)
            out[f"o_{w}"] = _np(o)
            out[f"counts_{w}"] = _counts(log)
            out[f"bytes_{w}"] = np.array(json.dumps(log.bytes))
    return out


def c_decode(world, model_parallel, context_parallel, heads):
    """decode_attention on this rank's slice of the cache."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import attention as A

    mesh = make_mesh_for(world, model_parallel=model_parallel)
    cfg, p, _ = _decode_layer(heads)
    x, k, v = _decode_inputs(heads[1])
    axis = "data" if context_parallel else "model"
    with SH.use_mesh(mesh):
        line = SH.axis_mesh(mesh, axis)
        init = A.init_kv_cache(cfg, 2, 32, device="cpu",
                               context_parallel=context_parallel)
        S_loc = init["k"].shape[2]
        lo = line.shard * S_loc
        cache = {"k": torch.as_tensor(k[:, :, lo:lo + S_loc]).clone(),
                 "v": torch.as_tensor(v[:, :, lo:lo + S_loc]).clone()}
        with SH.collective_log() as log:
            out, cache = A.decode_attention(
                torch.as_tensor(x), p, cfg, cache, 17, window=9,
                context_parallel=context_parallel)
    return {"out": _np(out), "k": _np(cache["k"]), "v": _np(cache["v"]),
            "lo": np.array(lo), "counts": _counts(log)}


def c_cp(world):
    """cp_decode_attention alone over the data axis (the reference check's
    shapes)."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.context_parallel import cp_decode_attention
    from repro_torch.launch.mesh import make_mesh_for

    mesh = make_mesh_for(world, model_parallel=1)
    line = SH.axis_mesh(mesh, "data")
    rng = np.random.default_rng(2)
    B, H, Hkv, S, d = 1, 4, 2, 64, 16
    q = torch.as_tensor(rng.normal(size=(B, H, 1, d)).astype(np.float32))
    k = rng.normal(size=(B, Hkv, S, d)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, d)).astype(np.float32)
    m = S // world
    sl = slice(line.shard * m, (line.shard + 1) * m)
    with SH.collective_log() as log:
        o = cp_decode_attention(q, torch.as_tensor(k[:, :, sl]),
                                torch.as_tensor(v[:, :, sl]), mesh=line,
                                kv_valid_len=50)
    return {"o": _np(o), "counts": _counts(log)}


def c_moe(world):
    """The expert-parallel moe_ffn, the experts cut by run_specs."""
    import torch

    from repro_torch import convert
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import model as M
    from repro_torch.models import moe as MO

    mesh = make_mesh_for(world, model_parallel=world)
    cfg, holder = _moe_module()
    convert.shard_params(holder, M.run_specs(cfg, holder, mesh), mesh)
    x = torch.as_tensor(_moe_x(cfg))
    with SH.use_mesh(mesh), SH.collective_log() as log:
        y = MO.moe_ffn(x, holder.moe, cfg)
    return {"y": _np(y), "experts": np.array(holder.moe.w_in.shape[0]),
            "counts": _counts(log)}


def c_slice(weights):
    """The reduced hymba slice served over (data 1, model 2): prefill and
    SLICE_STEPS decode steps on given tokens."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import model as M

    mesh = make_mesh_for(2, model_parallel=2)
    cfg = _slice_cfg(ARCHS["hymba-1.5b"])
    model = M.init_params(torch.Generator().manual_seed(0), cfg)
    with np.load(weights) as z, torch.no_grad():
        for name, t in model.named_parameters():
            t.copy_(torch.as_tensor(z[name]))
    convert.shard_params(model, M.run_specs(cfg, model, mesh), mesh)
    rng = np.random.default_rng(11)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab,
                                           (SLICE_B, SLICE_PROMPT)))
    steps = torch.as_tensor(rng.integers(0, cfg.vocab,
                                         (SLICE_B, SLICE_STEPS)))
    out = {}
    with SH.use_mesh(mesh), torch.no_grad():
        with SH.collective_log() as log:
            logits, cache = M.prefill(model, cfg, prompts,
                                      max_len=SLICE_PROMPT + SLICE_STEPS)
        out["prefill_counts"] = _counts(log)
        got = [logits[:, -1]]
        with SH.collective_log() as log:
            for i in range(SLICE_STEPS):
                logits, cache = M.decode_step(model, cfg, steps[:, i:i + 1],
                                              cache, SLICE_PROMPT + i)
                got.append(logits[:, -1])
        out["decode_counts"] = _counts(log)
    out["logits"] = _np(torch.stack(got, dim=1))
    out["cache_len"] = np.array(cache[0]["k"].shape[2])
    return out


CHILD_CHECKS = {"mesh": c_mesh, "seq_attn": c_seq_attn, "decode": c_decode,
                "cp": c_cp, "moe": c_moe, "slice": c_slice}


def world_checks(weights: str) -> dict:
    return {
        2: [["mesh@2", dict(world=2, model_parallel=2)],
            ["seq_attn", dict(**ATTN, windows=WINDOWS)],
            ["seq_attn@gqa", dict(**ATTN_GQA, windows=WINDOWS)],
            ["decode@2", dict(world=2, model_parallel=2,
                              context_parallel=False,
                              heads=DECODE_HEADS["decode@2"])],
            ["cp@2", dict(world=2)],
            ["moe@2", dict(world=2)],
            ["slice", dict(weights=weights)]],
        4: [["mesh@4", dict(world=4, model_parallel=2)],
            ["decode@4", dict(world=4, model_parallel=4,
                              context_parallel=False,
                              heads=DECODE_HEADS["decode@4"])],
            ["decode@4cp", dict(world=4, model_parallel=2,
                                context_parallel=True,
                                heads=DECODE_HEADS["decode@4cp"])],
            ["cp@4", dict(world=4)]],
    }


if __name__ == "__main__":
    sys.exit(child_main(sys.argv[1:], CHILD_CHECKS))


# ---------------------------------------------------------------------------
# the parent: the reference in-process, and the comparisons
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import specs as JS  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, specs  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

MESHES = {"d16m16": (("data", "model"), (16, 16)),
          "p2d16m16": (("pod", "data", "model"), (2, 16, 16)),
          "d2m2": (("data", "model"), (2, 2))}
NAMES = list(ARCHS)


def _spec(s) -> tuple:
    """A spec as a plain tuple, entries as tuples or names or None."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in s)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def slice_weights(tmp_path_factory):
    """The slice's reference tree (jax init, seed 0) as numpy, and the
    same weights saved under the port's parameter names for the ranks."""
    jcfg = _slice_cfg(JARCHS["hymba-1.5b"])
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    path = tmp_path_factory.mktemp("slice") / "weights.npz"
    np.savez(path, **dict(convert.lm_named_arrays(
        _slice_cfg(ARCHS["hymba-1.5b"]), tree)))
    return jcfg, tree, str(path)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, slice_weights):
    return Worlds(HERE, world_checks(slice_weights[2]), tmp_path_factory)


# -- rules, meshes and specs (no process group) ------------------------------

RULE_CALLS = [("act_btd", (64,)), ("act_bthd", (25,)), ("act_bthd", (32,)),
              ("w_in", (1600, 5504)), ("w_in", (1600, 25)),
              ("w_out", (5504, 1600)), ("w_expert", (128, 2048, 768)),
              ("w_expert", (7, 2048, 768)), ("embed", (32001, 1600)),
              ("embed", (32000, 2048)), ("kv_cache", (5,)),
              ("kv_cache", (32,)), ("kv_cache_cp", (8,))]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fsdp_pod", [False, True])
def test_axis_rules_match_reference(mesh, fsdp_pod):
    names, sizes = MESHES[mesh]
    SH.set_rules(fsdp_pod=fsdp_pod)
    JSH.set_rules(fsdp_pod=fsdp_pod)
    try:
        with SH.use_mesh(SH.AbstractMesh(names, sizes)), \
                jax.sharding.use_abstract_mesh(JAbstractMesh(sizes, names)):
            for fn, args in RULE_CALLS:
                got = getattr(SH.RULES, fn)(*args)
                want = getattr(JSH.RULES, fn)(*args)
                assert _spec(got) == _spec(want), (fn, args, got, want)
            assert SH.RULES.div(48, "model") == JSH.RULES.div(48, "model")
            assert SH.RULES.fsdp_axes == JSH.RULES.fsdp_axes
    finally:
        SH.set_rules(fsdp_pod=False)
        JSH.set_rules(fsdp_pod=False)


def test_rules_without_a_mesh_are_sizes_of_one():
    assert SH.current_mesh() is None
    assert SH.RULES._size(("pod", "data")) == 1
    assert _spec(SH.RULES.w_in(1600, 25)) == ("data", "model")
    t = torch.randn(3, 4)
    assert SH.constrain(t, SH.P("data", "model")) is t
    with pytest.raises(AttributeError):
        SH.set_rules(not_a_rule=1)


def test_constrain_keeps_a_plain_tensor_under_a_mesh():
    t = torch.randn(4, 8)
    with SH.use_mesh(SH.AbstractMesh(("data", "model"), (2, 2))):
        got = SH.constrain(t, SH.P(("pod", "data"), "model"))
    assert got is t and got.data_ptr() == t.data_ptr()


def test_production_meshes():
    """Shapes and names without building; building needs the ranks."""
    one = LM.production_mesh_shape()
    two = LM.production_mesh_shape(multi_pod=True)
    assert (one.axis_names, one.axis_sizes) == (("data", "model"), (16, 16))
    assert (two.axis_names, two.axis_sizes) == (("pod", "data", "model"),
                                                (2, 16, 16))
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        LM.make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        LM.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError):
        LM.make_mesh_for(6, model_parallel=4)


def _jax_tree_shapes(name):
    return jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                 JARCHS[name].reduced()))


def _port_model(name):
    return M.init_params(torch.Generator().manual_seed(0),
                         ARCHS[name].reduced())


def _by_port_name(cfg, tree):
    """``{port parameter name: reference spec}``: a stacked leaf's spec
    less its leading layer axis, for each layer."""
    stacks = {"layers": cfg.n_layers, "enc_layers": cfg.enc_layers}
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]:
        keys = [getattr(k, "key", str(k)) for k in path]
        if keys[0] in stacks:
            assert spec[0] is None
            for i in range(stacks[keys[0]]):
                out[".".join([keys[0], str(i)] + keys[1:])] = _spec(spec)[1:]
        else:
            out[".".join(keys)] = _spec(spec)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_match_reference(name, mesh):
    names, sizes = MESHES[mesh]
    jmesh = JAbstractMesh(sizes, names)
    pmesh = SH.AbstractMesh(names, sizes)
    model = _port_model(name)
    shapes = _jax_tree_shapes(name)
    for serve in (False, True):
        want = _by_port_name(ARCHS[name].reduced(), JM.param_specs(
            JARCHS[name].reduced(), shapes, jmesh, serve=serve))
        got = M.param_specs(ARCHS[name].reduced(), model, pmesh,
                            serve=serve)
        assert set(got) == set(want)
        bad = {k: (got[k], want[k]) for k in got
               if _spec(got[k]) != want[k]}
        assert not bad, list(bad.items())[:3]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_cache_and_input_specs_match_reference(name, mesh):
    names, sizes = MESHES[mesh]
    jmesh = JAbstractMesh(sizes, names)
    pmesh = SH.AbstractMesh(names, sizes)
    jcfg, cfg = JARCHS[name].reduced(), ARCHS[name].reduced()
    for cell in SHAPES:
        _, want = JS.input_specs(jcfg, JSHAPES[cell], jmesh)
        got = specs.input_pspecs(cfg, SHAPES[cell], pmesh)
        assert set(got) == set(want)
        for key in got:
            if key == "cache":
                continue
            g, w = got[key], want[key]
            if isinstance(w, dict):
                assert {k: _spec(v) for k, v in g.items()} == {
                    k: _spec(v) for k, v in w.items()}, (cell, key)
            else:
                assert (_spec(g) if g is not None else None) == (
                    _spec(w) if w is not None else None), (cell, key)
        if "cache" in got:
            wc = want["cache"]
            for i, layer in enumerate(got["cache"]):
                for k, s in layer.items():
                    ws = _spec(wc[k])
                    assert ws[0] is None
                    assert _spec(s) == ws[1:], (cell, i, k)


@dataclasses.dataclass(frozen=True)
class _PlacedMesh(SH.AbstractMesh):
    """A mesh's axes and this process's coordinate on them (a DeviceMesh's
    ``get_coordinate``), with no process group."""

    coordinate: tuple = ()

    def get_coordinate(self):
        return list(self.coordinate)


def test_shard_params_cuts_by_spec():
    """A (4, 6) weight over (data 2, model 2): rows by data, columns by
    model, the block of each coordinate; unnamed axes ignored."""
    from torch import nn

    m = nn.Module()
    m.w = nn.Parameter(torch.arange(24.0).reshape(4, 6),
                       requires_grad=False)
    m.b = nn.Parameter(torch.arange(6.0), requires_grad=False)
    for coord in [(0, 0), (0, 1), (1, 0), (1, 1)]:
        mesh = _PlacedMesh(("data", "model"), (2, 2), coord)
        mm = nn.Module()
        mm.w = nn.Parameter(m.w.clone(), requires_grad=False)
        mm.b = nn.Parameter(m.b.clone(), requires_grad=False)
        convert.shard_params(mm, {"w": SH.P("data", "model"),
                                  "b": SH.P(("pod", "model"))}, mesh)
        i, j = coord
        assert torch.equal(mm.w, m.w[2 * i:2 * i + 2, 3 * j:3 * j + 3])
        assert torch.equal(mm.b, m.b[3 * j:3 * j + 3])
        assert mm.w.is_contiguous()


# -- the gloo worlds ---------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_mesh_and_constrain_in_a_world(worlds, world):
    out = worlds(world)
    for rank in range(world):
        got = load(out, f"mesh@{world}", rank)
        assert tuple(got["shape"]) == (world // 2, 2)
        assert list(got["names"]) == ["data", "model"]
        assert bool(got["same_ptr"]) and int(got["size"]) == 2
        # 'pod' dropped, 'data' kept (Shard(0)), 'model' Shard(1)
        assert list(got["placements"]) == [False, True, True, False]
        full = np.arange(32.0).reshape(4, 8)
        r = rank // 2 if world == 4 else 0
        c = rank % 2
        rows = 4 // (world // 2)
        np.testing.assert_array_equal(
            got["local"], full[r * rows:(r + 1) * rows, 4 * c:4 * c + 4])


def _attention_want(B, H, Hkv, S, d, seed, window):
    from repro.models.attention import _chunked

    rng = np.random.default_rng(seed)
    q, k, v = (jnp.asarray(rng.normal(size=s).astype(np.float32))
               for s in ((B, H, S, d), (B, Hkv, S, d), (B, Hkv, S, d)))
    return np.asarray(_chunked(q, k, v, causal=True, window=window,
                               cap=None, scale=d ** -0.5, q_offset=0,
                               block_q=16, block_k=16))


@pytest.mark.parametrize("case", ["seq_attn", "seq_attn@gqa"])
@pytest.mark.parametrize("window", WINDOWS)
def test_seq_sharded_attention_matches_reference(worlds, case, window):
    """Each rank's query slice through K13's plain version equals the
    reference's attention of the whole sequence, to 1e-4; the global
    layers all-gather k and v once, the halo layers ppermute once."""
    shape = ATTN if case == "seq_attn" else ATTN_GQA
    want = _attention_want(**shape, window=window)
    out = worlds(2)
    S_loc = shape["S"] // 2
    halo = window is not None and window < S_loc
    for rank in range(2):
        got = load(out, case, rank)
        part = want[:, :, rank * S_loc:(rank + 1) * S_loc]
        assert float(np.abs(got[f"o_{window}"] - part).max()) < 1e-4
        counts = json.loads(str(got[f"counts_{window}"]))
        nbytes = json.loads(str(got[f"bytes_{window}"]))
        kv = 2 * shape["B"] * shape["Hkv"] * shape["d"] * 4
        if halo:
            assert counts == {"ppermute": 1}
            # the first rank sends, the last receives: window rows of k, v
            assert nbytes == {"ppermute": kv * window}
        else:
            assert counts == {"all_gather": 1}
            assert nbytes == {"all_gather": kv * shape["S"]}


def _decode_want(heads):
    from repro.models import attention as JA

    cfg, _, arrays = _decode_layer(heads)
    p = {name.split(".")[0]: {"w": jnp.asarray(a)}
         for name, a in arrays.items()}
    x, k, v = _decode_inputs(heads[1])
    out, nc = JA.decode_attention(jnp.asarray(x), p, cfg,
                                  {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                                  jnp.asarray(17, jnp.int32), window=9)
    return np.asarray(out), np.asarray(nc["k"]), np.asarray(nc["v"])


@pytest.mark.parametrize("case", ["decode@2", "decode@4", "decode@4cp"])
def test_seq_sharded_decode_matches_reference(worlds, case):
    """The sequence-sharded decode (over 'model', or over 'data' with
    context_parallel) equals the reference's decode on one device: output
    to 1e-4, the cache to 1e-6; one pmax and one psum a step, and only the
    owning rank's cache changes."""
    world = 2 if case == "decode@2" else 4
    out = worlds(world)
    want_o, want_k, want_v = _decode_want(DECODE_HEADS[case])
    for rank in range(world):
        got = load(out, case, rank)
        assert float(np.abs(got["out"] - want_o).max()) < 1e-4
        lo = int(got["lo"])
        m = got["k"].shape[2]
        assert float(np.abs(got["k"] - want_k[:, :, lo:lo + m]).max()) < 1e-6
        assert float(np.abs(got["v"] - want_v[:, :, lo:lo + m]).max()) < 1e-6
        assert json.loads(str(got["counts"])) == {"pmax": 1, "psum": 1}


@pytest.mark.parametrize("world", [2, 4])
def test_cp_decode_attention_matches_reference(worlds, world):
    from repro.kernels.ref import attention_ref

    rng = np.random.default_rng(2)
    B, H, Hkv, S, d = 1, 4, 2, 64, 16
    q = jnp.asarray(rng.normal(size=(B, H, 1, d)).astype(np.float32))
    k = jnp.asarray(rng.normal(size=(B, Hkv, S, d)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(B, Hkv, S, d)).astype(np.float32))
    want = np.asarray(attention_ref(q, k[:, :, :50], v[:, :, :50],
                                    causal=False))
    out = worlds(world)
    for rank in range(world):
        got = load(out, f"cp@{world}", rank)
        assert float(np.abs(got["o"] - want).max()) < 1e-4
        assert json.loads(str(got["counts"])) == {"pmax": 1, "psum": 1}


def test_expert_parallel_moe_matches_reference(worlds):
    """Half the experts a rank and one psum equal the reference's local
    moe_ffn, to 1e-5 of max |y|."""
    from repro.models import moe as JMO

    cfg, holder = _moe_module()
    p = {k: jnp.asarray(v.detach().numpy())
         for k, v in holder.moe.named_parameters()}
    want = np.asarray(JMO.moe_ffn(jnp.asarray(_moe_x(cfg)), p,
                                  JARCHS["qwen3-moe-30b-a3b"].reduced()))
    out = worlds(2)
    for rank in range(2):
        got = load(out, "moe@2", rank)
        assert int(got["experts"]) == cfg.n_experts // 2
        assert _rel(got["y"], want) < 1e-5
        assert json.loads(str(got["counts"])) == {"psum": 1}


def test_sharded_hymba_slice_matches_reference(worlds, slice_weights):
    """The reduced hymba (5 heads, 1 KV head) prefilled and decoded 4 steps
    over (data 1, model 2) against the reference's prefill and
    decode_step on one device: logits to 1e-4 of max |logit|; the cache
    half a rank; the collectives the branches issue."""
    jcfg, tree, _ = slice_weights
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, jcfg.vocab, (SLICE_B, SLICE_PROMPT))
    steps = rng.integers(0, jcfg.vocab, (SLICE_B, SLICE_STEPS))
    logits, cache = JM.prefill(tree, jcfg, jnp.asarray(prompts, jnp.int32),
                               max_len=SLICE_PROMPT + SLICE_STEPS)
    want = [np.asarray(logits[:, -1])]
    for i in range(SLICE_STEPS):
        logits, cache = JM.decode_step(
            tree, jcfg, jnp.asarray(steps[:, i:i + 1], jnp.int32), cache,
            jnp.asarray(SLICE_PROMPT + i, jnp.int32))
        want.append(np.asarray(logits[:, -1]))
    want = np.stack(want, axis=1)
    scale = float(np.abs(want).max())
    out = worlds(2)
    n_glob = sum(w is None for w in jcfg.window_pattern())
    n_win = jcfg.n_layers - n_glob
    for rank in range(2):
        got = load(out, "slice", rank)
        err = float(np.abs(got["logits"] - want).max())
        assert err <= 1e-4 * scale, (rank, err, scale)
        assert int(got["cache_len"]) == (SLICE_PROMPT + SLICE_STEPS) // 2
        # prefill: per global layer an all-gather of k, v and one of the
        # output; per windowed layer a ppermute and the output's gather
        assert json.loads(str(got["prefill_counts"])) == {
            "all_gather": 2 * n_glob + n_win, "ppermute": n_win}
        assert json.loads(str(got["decode_counts"])) == {
            "pmax": SLICE_STEPS * jcfg.n_layers,
            "psum": SLICE_STEPS * jcfg.n_layers}
