"""The port's mesh layer (``models/pspec``, ``launch/mesh``,
``launch/sharding``) on the CPU: the twins of ``tests/test_sharding.py``,
its specs equal to the reference's leaf for leaf, and the 1x1 meshed
train and decode steps bit-equal to the unmeshed port and within
``tests/test_torch_models.py``'s tolerances of the reference.

The 1x1 mesh is a one-rank ``gloo`` group (a ``HashStore``, per test);
meshes of more ranks run on fake ranks in ``tests/test_torch_dryrun.py``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.configs as RC
from repro.launch import sharding as j_sharding
from repro.models import decode_step as j_decode, init_params as j_init
from repro.models import model as j_model
from repro.train import AdamWConfig as JAdamW
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step

import repro_torch.configs as C
from repro_torch import convert, pytree
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.models import decode_step, init_cache, init_params, pspec
from repro_torch.train import (AdamWConfig, init_train_state,
                               make_train_step)

CPU = "cpu"
B, S = 4, 32
# tests/test_torch_models.py's float32 tolerances (summation order only)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast, and keeps parallel test workers from oversubscribing the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mesh11():
    """A 1x1 ``("data", "model")`` mesh over a one-rank gloo group."""
    from torch.distributed.device_mesh import DeviceMesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield DeviceMesh(CPU, torch.arange(1).reshape(1, 1),
                         mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _stub(data, model):
    """What the spec functions read of a mesh, at any size."""
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(data, model))


def _fake_tree(fn):
    with FakeTensorMode():
        return fn()


def _entries(spec) -> tuple:
    """A spec's entries; a tuple of one mesh axis is that axis (JAX's
    ``PartitionSpec`` writes ``("data",)`` as ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _specs_by_path(tree) -> dict:
    return {p: _entries(s) for p, s in pytree.leaves_with_paths(tree)}


def _j_specs_by_path(tree) -> dict:
    from jax.sharding import PartitionSpec as JP
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(k.key) for k in path): _entries(s)
            for path, s in flat}


def _np_batch(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    media = (rng.standard_normal((b, cfg.n_media_tokens, cfg.d_model))
             .astype(np.float32) if cfg.n_media_tokens else None)
    return toks, media


# ----------------------------------------------- twins of test_sharding.py
@pytest.mark.parametrize("arch", C.list_archs())
def test_param_specs_cover_tree(arch, mesh11):
    cfg = C.get(arch)
    shapes = _fake_tree(lambda: init_params(cfg, 0, device=CPU))
    specs = sharding.param_specs(cfg, shapes, mesh11)
    flat_s = pytree.leaves_with_paths(specs)
    flat_p = pytree.leaves_with_paths(shapes)
    assert [p for p, _ in flat_s] == [p for p, _ in flat_p]
    for (_, spec), (path, leaf) in zip(flat_s, flat_p):
        assert isinstance(spec, pspec.PartitionSpec)
        assert len(spec) <= leaf.ndim
        # big matrices must actually be sharded somewhere
        if leaf.numel() > 4_000_000:
            assert any(a is not None for a in spec), (arch, path)


def _meshed_step(cfg, mesh):
    """(unmeshed state, metrics, meshed state, metrics, params, batch)."""
    params = init_params(cfg, 0, device=CPU)
    toks, media = _np_batch(cfg)
    batch = {"tokens": torch.from_numpy(toks)}
    if media is not None:
        batch["media"] = torch.from_numpy(media)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), n_microbatches=2)
    plain, pm = step(init_train_state(cfg, params, device=CPU), batch)
    state = init_train_state(cfg, params, device=CPU)
    dstate = sharding.distribute_tree(
        state, sharding.state_specs(cfg, state, mesh), mesh)
    dbatch = sharding.distribute_tree(batch, sharding.batch_specs(
        cfg, mesh, with_media=media is not None), mesh)
    with pspec.use_mesh(mesh, pspec.default_mapping(False)):
        meshed, mm = step(dstate, dbatch)
    return plain, pm, meshed, mm, params, (toks, media)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "dbrx-132b",
                                  "zamba2-1.2b", "rwkv6-3b"])
def test_train_step_lowers_on_mesh(arch, mesh11):
    """Reduced config, 1x1 mesh: the step the dry-run traces, equal to the
    unmeshed port bit for bit and to the reference within a tenth of lr
    (``tests/test_torch_train.py``'s bound for an AdamW step)."""
    cfg = C.get(arch).reduced()
    plain, pm, meshed, mm, params, (toks, media) = _meshed_step(cfg, mesh11)
    assert float(pm["loss"]) == float(mm["loss"].full_tensor())
    for (name, a), b in zip(pytree.leaves_with_paths(plain),
                            pytree.leaves(meshed)):
        assert torch.equal(a, b.full_tensor()), name
    rcfg = RC.get(arch).reduced()
    jopt = JAdamW(lr=1e-3)
    jstate = j_init_state(rcfg, jax.tree.map(
        jnp.asarray, convert.lm_params_to_numpy(params)), jopt)
    jbatch = {"tokens": jnp.asarray(toks)}
    if media is not None:
        jbatch["media"] = jnp.asarray(media)
    jstate, jm = jax.jit(j_make_step(rcfg, jopt, n_microbatches=2))(
        jstate, jbatch)
    assert float(mm["loss"].full_tensor()) == pytest.approx(
        float(jm["loss"]), rel=1e-5)
    got = dict(pytree.leaves_with_paths(convert.lm_params_to_numpy(
        pytree.tree_map(lambda t: t.full_tensor(), meshed["params"]))))
    for name, want in pytree.leaves_with_paths(
            jax.tree.map(np.asarray, jstate["params"])):
        np.testing.assert_allclose(got[name], want, rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["gemma3-27b", "deepseek-v2-236b",
                                  "rwkv6-3b"])
def test_decode_lowers_on_mesh(arch, mesh11):
    """Three decode steps from an empty cache on the 1x1 mesh: the
    unmeshed port's logits and cache bit for bit, the reference's logits
    within the LM tolerance."""
    cfg, rcfg = C.get(arch).reduced(), RC.get(arch).reduced()
    params = init_params(cfg, 0, device=CPU)
    toks, _ = _np_batch(cfg, s=3)
    cache = init_cache(cfg, B, 64, device=CPU)
    dparams = sharding.distribute_tree(
        params, sharding.param_specs(cfg, params, mesh11), mesh11)
    dcache = sharding.distribute_tree(
        init_cache(cfg, B, 64, device=CPU),
        sharding.cache_specs(cfg, cache, mesh11, B), mesh11)
    jp = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(params))
    jcache = j_model.init_cache(rcfg, B, 64)
    jstep = jax.jit(lambda c, t: j_decode(rcfg, jp, c, t))
    for t in range(3):
        tok = torch.from_numpy(toks[:, t])
        want, cache = decode_step(cfg, params, cache, tok)
        dtok = sharding.distribute_tree(
            {"t": tok}, {"t": pspec.P(("data",))}, mesh11)["t"]
        with pspec.use_mesh(mesh11, pspec.default_mapping(False)):
            got, dcache = decode_step(cfg, dparams, dcache, dtok)
        assert torch.equal(want, got.full_tensor())
        jl, jcache = jstep(jcache, jnp.asarray(toks[:, t]))
        np.testing.assert_allclose(got.full_tensor().numpy(),
                                   np.asarray(jl), **LOGIT_TOL)
    for (name, a), b in zip(pytree.leaves_with_paths(cache),
                            pytree.leaves(dcache)):
        assert (a == b) if isinstance(a, int) else torch.equal(
            a, b.full_tensor()), name


def test_pspec_noop_without_mesh():
    x = torch.ones((4, 4))
    assert pspec.constrain(x, "batch", None) is x


def test_pspec_divisibility_guard(mesh11):
    from torch.distributed.tensor import Replicate, Shard
    with pspec.use_mesh(mesh11, {"heads": "model"}):
        x = torch.ones((3, 5))
        y = pspec.constrain(x, "heads", None)   # 3 % 1 == 0 -> fine
        assert y.shape == x.shape
        assert tuple(y.placements) == (Replicate(), Shard(0))
        # a dim of 1 is never sharded: its one shard is the whole
        z = pspec.constrain(torch.ones((1, 5)), "heads", None)
        assert tuple(z.placements) == (Replicate(), Replicate())
    assert pspec.get_mesh() is None


def test_mesh_factory_requires_devices(mesh11):
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        mesh_lib.make_production_mesh(device=CPU)   # 1 rank < 256
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        mesh_lib.make_production_mesh(multi_pod=True, device=CPU)


# ------------------------------------------- specs equal to the reference
def _both_trees(arch, what):
    cfg, rcfg = C.get(arch), RC.get(arch)
    key = jax.random.PRNGKey(0)
    if what == "params":
        return (_fake_tree(lambda: init_params(cfg, 0, device=CPU)),
                jax.eval_shape(lambda k: j_init(rcfg, k), key))
    if what == "state":
        port = _fake_tree(lambda: init_train_state(
            cfg, init_params(cfg, 0, device=CPU), device=CPU))
        ref = jax.eval_shape(lambda k: j_init_state(rcfg, j_init(rcfg, k)),
                             key)
        return port, ref
    return (_fake_tree(lambda: init_cache(cfg, what, 64, device=CPU)),
            jax.eval_shape(lambda: j_model.init_cache(rcfg, what, 64)))


@pytest.mark.parametrize("what", ["params", "state", 4, 1])
@pytest.mark.parametrize("arch", C.list_archs())
def test_specs_equal_reference(arch, what):
    """param / state / cache (batch 4 and 1) specs, leaf for leaf, on a
    1x1 mesh and after ``sanitize_specs`` at 16x16."""
    from jax.sharding import Mesh
    cfg, rcfg = C.get(arch), RC.get(arch)
    port_tree, ref_tree = _both_trees(arch, what)
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))

    def specs(fn_port, fn_ref):
        return fn_port(_stub(1, 1)), fn_ref(jmesh)
    if what == "params":
        got, want = specs(
            lambda m: sharding.param_specs(cfg, port_tree, m),
            lambda m: j_sharding.param_specs(rcfg, ref_tree, m))
    elif what == "state":
        got, want = specs(
            lambda m: sharding.state_specs(cfg, port_tree, m),
            lambda m: j_sharding.state_specs(rcfg, ref_tree, m))
    else:
        got, want = specs(
            lambda m: sharding.cache_specs(cfg, port_tree, m, what),
            lambda m: j_sharding.cache_specs(rcfg, ref_tree, m, what))
    assert _specs_by_path(got) == _j_specs_by_path(want)
    big = types.SimpleNamespace(shape={"data": 16, "model": 16})
    assert _specs_by_path(sharding.sanitize_specs(
        got, port_tree, _stub(16, 16))) == _j_specs_by_path(
        j_sharding.sanitize_specs(want, ref_tree, big))


def test_placements_follow_specs(mesh11):
    """A tuple entry shards one dim over several mesh dims, major first;
    out of mesh order it is refused."""
    from torch.distributed.tensor import Replicate, Shard
    mesh3 = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                  ndim=3)
    P = pspec.P
    assert pspec.placements(P(("pod", "data"), None, "model"), mesh3) == (
        Shard(0), Shard(0), Shard(2))
    assert pspec.placements(P(None, None), mesh3) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        pspec.placements(P(("data", "pod")), mesh3)
    placed = sharding.to_placements({"a": P("model", "data")}, mesh11)
    assert placed == {"a": (Shard(1), Shard(0))}
