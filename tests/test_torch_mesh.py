"""The port's mesh half against the reference's, on the CPU, in-process:

- ``launch.mesh`` builds the production meshes (16×16 ("data", "model"),
  2×16×16 ("pod", "data", "model")) under the ``fake`` process group at
  world 256 and 512 (no devices, no processes);
- ``sharding.rules.placements`` of every resolved spec gives the
  reference's local shard shapes, ``NamedSharding(AbstractMesh(...),
  spec).shard_shape``, for every parameter (per layer, the reference's
  stacked leaf without its stacking axis), decode-cache and batch leaf of
  every arch × applicable shape, on both meshes; ``default_rules`` equal;
- a tensor dim sharded over a tuple out of mesh order raises, and neither
  ``default_rules`` nor any autotuner move makes one;
- ``sharding.act.constrain`` is the identity without a context (the same
  tensor object back);
- ``runtime.elastic.shrink_mesh`` equals the reference for n = 1…600, and
  ``state_shardings`` gives the reference's specs for every state leaf.

Each meshed test starts the fake process group in this process and
destroys it at its end: a process holds one default group.
"""
import contextlib
import math

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs.registry import arch_names  # noqa: E402
from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.runtime import elastic as RE  # noqa: E402
from repro.sharding import rules as RR  # noqa: E402
from repro.sharding import specs as RS  # noqa: E402
from repro_torch.configs.base import SHAPES, shape_applicable  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import autotune as PAT  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.runtime import elastic as PE  # noqa: E402
from repro_torch.sharding import rules as PR  # noqa: E402
from repro_torch.sharding import specs as PS  # noqa: E402
from repro_torch.sharding.act import constrain, current_context  # noqa: E402

MESHES = {"16x16": (False, (16, 16), ("data", "model")),
          "2x16x16": (True, (2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_mesh(name):
    multi_pod, shape, axes = MESHES[name]
    world = 1
    for n in shape:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield make_production_mesh(multi_pod=multi_pod, device_type="cpu"), AbstractMesh(shape, axes)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ref_structs():
    """The reference's parameter (f32) and decode-cache (bf16) structs of
    every arch, traced without allocating."""
    out = {}
    for arch in arch_names():
        cfg = ref_config(arch)
        params = jax.eval_shape(lambda k: RM.init_params(cfg, k, dtype=jnp.float32), jax.random.PRNGKey(0))
        caches = {s.name: jax.eval_shape(lambda s=s: RM.init_cache(cfg, s.global_batch, s.seq_len, jnp.bfloat16))
                  for s in REF_SHAPES.values() if s.kind == "decode"}
        out[arch] = (params, caches)
    return out


def leaves(tree, logical, path=()):
    """(path, struct, logical) of every leaf of a reference struct tree."""
    if hasattr(tree, "shape"):
        yield path, tree, logical
    elif isinstance(tree, dict):
        for k in tree:
            yield from leaves(tree[k], logical[k], path + (k,))
    else:
        for i, (t, l) in enumerate(zip(tree, logical)):
            yield from leaves(t, l, path + (i,))


def batch_shapes(cfg, shape):
    b, s = shape.global_batch, 1 if shape.kind == "decode" else shape.seq_len
    out = {"tokens": (b, s)} if cfg.input_mode == "tokens" else {"embeds": (b, s, cfg.d_model)}
    if shape.kind == "train":
        out["labels"] = (b, s)
    if cfg.rope_kind == "mrope":
        out["mrope_positions"] = (3, b, s)
    return out


def cells():
    for arch in arch_names():
        for name, shape in SHAPES.items():
            if shape_applicable(get_config(arch), shape):
                yield arch, name


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_local_shard_shapes_equal_the_references(ref_structs, mesh_name):
    checked = 0
    with fake_mesh(mesh_name) as (mesh, amesh):
        for arch, shape_name in cells():
            cfg, rcfg, shape = get_config(arch), ref_config(arch), SHAPES[shape_name]
            rules = PR.default_rules(cfg, shape, mesh)
            rrules = RR.default_rules(rcfg, REF_SHAPES[shape_name], amesh)
            assert rules == rrules, (arch, shape_name)

            def same(shp, logical, r_shp, r_logical, what):
                nonlocal checked
                spec = PR.resolve(shp, logical, rules, PR.axes(mesh))
                got = PR.Sharding.of(mesh, spec).local_shape(shp)
                want = NamedSharding(amesh, RR.resolve(r_shp, r_logical, rrules, amesh)).shard_shape(r_shp)
                assert got == tuple(want[len(r_shp) - len(shp):]), (arch, shape_name, what, spec)
                checked += 1

            params, caches = ref_structs[arch]
            ref_leaves = {p: (s, l) for p, s, l in leaves(params, RS.param_logical(rcfg))}
            for name, logical in PS.named_param_logical(cfg).items():
                parts = name.split(".")
                if parts[0] == "layers":  # layer i ↔ the reference's cycle position i % cycle_len
                    key = ("layers", int(parts[1]) % cfg.cycle_len, *parts[2:])
                else:
                    key = tuple(parts)
                r_struct, r_logical = ref_leaves[key]
                shp = tuple(r_struct.shape[1:]) if parts[0] == "layers" else tuple(r_struct.shape)
                same(shp, logical, tuple(r_struct.shape), r_logical, name)
            if shape.kind == "decode":
                logical = PS.cache_logical(cfg)
                for path, s, l in leaves(caches[shape_name], RS.cache_logical(rcfg)):
                    pos = path[0]
                    port = logical[pos]
                    for k in path[1:]:
                        port = port[k]
                    same(tuple(s.shape[1:]), port[1:], tuple(s.shape), l, f"cache{path}")
            b_logical = PS.batch_logical(cfg, shape.kind)
            for k, shp in batch_shapes(cfg, shape).items():
                same(shp, b_logical[k], shp, RS.batch_logical(rcfg, shape.kind)[k], k)
    assert checked > 2000, checked


def test_a_tuple_out_of_mesh_order_raises():
    with fake_mesh("2x16x16") as (mesh, _):
        assert PR.placements((("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
        with pytest.raises(ValueError, match="out of the mesh order"):
            PR.placements((("data", "pod"), None), mesh)
        with pytest.raises(ValueError, match="out of the mesh order"):
            PR.placements((None, ("model", "data")), mesh)
        with pytest.raises(ValueError, match="not in the mesh"):
            PR.placements(("expert",), mesh)
        with pytest.raises(ValueError, match="shards two dims"):
            PR.placements(("model", "model"), mesh)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_rules_and_autotuner_moves_keep_mesh_order(mesh_name):
    """Every rule value of ``default_rules``, and of every move the
    autotuner can apply to it, lists its axes in mesh order (the moves set
    single axes), so ``placements`` never meets an out-of-order tuple."""
    with fake_mesh(mesh_name) as (mesh, _):
        order = {a: i for i, a in enumerate(mesh.mesh_dim_names)}
        knobs = {knob for dom in ("collective", "memory", "compute") for shape in SHAPES.values()
                 for _, knob in PAT.moves_for(dom, shape, get_config("jamba-v0.1-52b"))}
        assert {"tp_off", "tp_on", "seq_res_off", "seq_res_on"} <= knobs
        n = 0
        for arch, shape_name in cells():
            rules = PR.default_rules(get_config(arch), SHAPES[shape_name], mesh)
            dists = [PR.DistConfig(rules=rules)]
            for knob in sorted(knobs):
                moved = PAT.apply_move(dists[0], knob)
                if moved is not None:
                    dists.append(moved[0])
            for d in dists:
                for value in d.rules.values():
                    if isinstance(value, tuple):
                        idx = [order[a] for a in value if a in order]
                        assert idx == sorted(idx), (arch, shape_name, value)
                        n += 1
        assert n > 100


def test_constrain_is_the_identity_without_a_context():
    assert current_context() is None
    x = torch.randn(4, 8, 16)
    assert constrain(x, ("batch", "seq_res", "act_embed")) is x
    assert constrain(x, (None, None, None)) is x


def test_in_context_carries_the_context_to_another_thread():
    """Autograd runs a CUDA backward, activation-checkpoint recomputes
    included, on its own device thread, where the context variable is
    unset; a function bound by ``in_context`` sees the forward's context
    there (and leaves it unset after)."""
    import threading

    from repro_torch.sharding.act import activation_rules, in_context

    seen = {}
    probe = lambda key: seen.__setitem__(key, current_context())  # noqa: E731
    with fake_mesh("16x16") as (mesh, _):
        rules = {"batch": ("data",)}
        with activation_rules(rules, mesh):
            bound = in_context(probe)
            for key, fn in (("plain", probe), ("bound", bound)):
                t = threading.Thread(target=fn, args=(key,))
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
        assert seen["plain"] is None and seen["bound"] == (rules, mesh)
        assert current_context() is None
    assert in_context(probe) is probe  # no context: nothing to bind


def test_shrink_mesh_equals_the_reference():
    for n in range(1, 601):
        for model_axis in (16, 8, 2):
            assert PE.shrink_mesh(n, model_axis) == RE.shrink_mesh(n, model_axis), (n, model_axis)


@pytest.mark.parametrize("arch,shape_name", [("qwen3-1.7b", "train_4k"), ("jamba-v0.1-52b", "train_4k"),
                                             ("grok-1-314b", "train_4k")])
def test_state_shardings_equal_the_references(ref_structs, arch, shape_name):
    """``state_shardings`` on a meta-tensor state: each leaf's spec is the
    reference's (per layer without the stacking axis), and its placements
    are that spec's; ``tree_sharded_structs`` describes the parameters
    with the same shardings."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    params, _ = ref_structs[arch]
    r_state = {"params": params, "opt": {"m": params, "v": params, "count": jax.ShapeDtypeStruct((), jnp.int32)},
               "step": jax.ShapeDtypeStruct((), jnp.int32)}
    with fake_mesh("16x16") as (mesh, amesh):
        ref = RE.state_shardings(rcfg, REF_SHAPES[shape_name], amesh, r_state)
        ref_specs = {}

        def walk(node, path=()):
            if isinstance(node, NamedSharding):
                ref_specs[path] = tuple(node.spec)
            elif isinstance(node, dict):
                for k in node:
                    walk(node[k], path + (k,))
            else:
                for i, v in enumerate(node):
                    walk(v, path + (i,))

        walk(ref)
        named = {}
        for name in PS.named_param_logical(cfg):
            parts = name.split(".")
            key = ("layers", int(parts[1]) % cfg.cycle_len, *parts[2:]) if parts[0] == "layers" else tuple(parts)
            shp = params
            for k in key:
                shp = shp[k]
            named[name] = (torch.empty(shp.shape[1:] if parts[0] == "layers" else shp.shape, device="meta"), key)
        meta = {n: t for n, (t, _) in named.items()}
        state = {"params": meta, "opt": {"m": meta, "v": meta, "count": torch.empty((), device="meta")},
                 "step": torch.empty((), device="meta")}
        got = PE.state_shardings(cfg, SHAPES[shape_name], mesh, state)
        for name, (_, key) in named.items():
            for tree, prefix in ((got["params"], ("params",)), (got["opt"]["m"], ("opt", "m")),
                                 (got["opt"]["v"], ("opt", "v"))):
                want = ref_specs[prefix + key]
                want = want[1:] if key[0] == "layers" else want
                assert tree[name].spec == want, (name, tree[name].spec, want)
                assert tree[name].placements == PR.placements(want, mesh)
        assert got["step"].placements == (Replicate(),) * 2
        rules = PR.default_rules(cfg, SHAPES[shape_name], mesh)
        structs = PR.tree_sharded_structs(meta, PS.named_param_logical(cfg), rules, mesh)
        for name, st in structs.items():
            assert st.sharding == got["params"][name] and st.shape == tuple(meta[name].shape)
            assert st.local_nbytes == 4 * math.prod(st.local_shape)
        assert got["opt"]["count"].spec == ()
