"""The port's mesh and rule tables against the JAX package's, without any
process group: ``Mesh`` shapes (no groups) beside ``jax.make_mesh`` over the
8 forced host devices (tests/conftest.py).

  * every leaf of every config's ``param_specs`` (full and smoke) under
    all five rule tables on the (2, 2, 2), (2, 1, 2), (1, 2, 2) and
    (1, 1, 4) meshes: the port's spec equals the reference's;
  * ``batch_spec``, ``batch_axes`` inside and outside ``manual_axes``,
    ``model_axis``, the ``default_mesh`` sizing of 1, 2, 4 and 8 ranks,
    the row-major rank layout, the production shapes, and every kind's
    ``decode_state_shardings`` (the dense kinds at the cases of
    tests/test_dist.py, rwkv6, zamba2 and whisper at the same);
  * ``shard_tensor`` / ``shard_shape`` against the blocks the
    reference's ``NamedSharding`` gives each device."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding

from repro import configs as jconfigs
from repro.dist import meshctx as jmeshctx
from repro.dist import sharding as jsharding
from repro.launch import mesh as jlaunch_mesh
from repro.models import registry as jregistry
from repro_torch import configs
from repro_torch.dist import meshctx, sharding
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import nn, registry

SHAPES = [(2, 2, 2), (2, 1, 2), (1, 2, 2), (1, 1, 4)]
AXES = ("pod", "data", "model")
TABLES = ("PARAM_RULES", "EP_PARAM_RULES", "NO_FSDP_RULES",
          "SERVE_RESIDENT_RULES", "ACT_RULES")


def _meshes(shape):
    n = int(np.prod(shape))
    return (jax.make_mesh(shape, AXES, devices=jax.devices()[:n]),
            meshctx.Mesh(shape))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def test_rule_tables_are_the_reference_tables():
    for name in TABLES:
        assert getattr(sharding, name) == getattr(jsharding, name), name


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_param_specs_resolve_as_the_reference(shape, smoke):
    """Every leaf of every architecture under every table."""
    jmesh, mesh = _meshes(shape)
    get = "get_smoke_config" if smoke else "get_config"
    n = 0
    for arch in configs.ARCHS:
        jspecs = jregistry.param_specs(getattr(jconfigs, get)(arch))
        specs = registry.param_specs(getattr(configs, get)(arch))
        for table in TABLES:
            want = jsharding.param_shardings(jspecs, jmesh,
                                             getattr(jsharding, table))
            got = sharding.param_shardings(specs, mesh,
                                           getattr(sharding, table))
            wl, gl = list(_flat(want)), list(_flat(got))
            assert [p for p, _ in wl] == [p for p, _ in gl], arch
            for (path, w), (_, g) in zip(wl, gl):
                assert tuple(g.spec) == tuple(w.spec), (arch, table, path)
                n += 1
    assert n >= 5 * 150  # ten configs, five tables


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_spec_for_axes_corner_cases(shape):
    jmesh, mesh = _meshes(shape)
    cases = [(("embed", "mlp"), (3, 8)), (("embed", "embed"), (8, 8)),
             (("vocab_in", "embed"), (6, 4)), (("layers", "heads"), (2, 6)),
             ((None, "kv"), (4, 12)), (("expert", "embed", "mlp"), (4, 8, 8))]
    for axes, dims in cases:
        for table in TABLES:
            assert tuple(sharding.spec_for_axes(
                axes, dims, mesh, getattr(sharding, table))) == tuple(
                jsharding.spec_for_axes(axes, dims, jmesh,
                                        getattr(jsharding, table)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_batch_spec_and_axes(shape):
    jmesh, mesh = _meshes(shape)
    for ndim in (1, 2, 3):
        for dim in (1, 2, 3, 4, 6, 8, 16):
            assert tuple(sharding.batch_spec(mesh, ndim, dim)) == tuple(
                jsharding.batch_spec(jmesh, ndim, dim)), (ndim, dim)
    for dim in (None, 2, 3, 8):
        assert meshctx.batch_axes(mesh, dim) == jmeshctx.batch_axes(
            jmesh, dim)
        for manual in ({"pod"}, {"data"}, {"pod", "data"}):
            with meshctx.manual_axes(manual), jmeshctx.manual_axes(manual):
                assert meshctx.get_manual_axes() == jmeshctx.get_manual_axes()
                assert meshctx.batch_axes(mesh, dim) == jmeshctx.batch_axes(
                    jmesh, dim)
                assert tuple(sharding.batch_spec(mesh, 2, 8)) == tuple(
                    jsharding.batch_spec(jmesh, 2, 8))
                assert meshctx.model_axis(mesh) == jmeshctx.model_axis(jmesh)
    assert meshctx.model_axis(mesh) == jmeshctx.model_axis(jmesh)
    assert meshctx.get_manual_axes() == frozenset()


def test_batch_spec_divisibility_as_test_dist():
    """tests/test_dist.py's cases on the port's (2, 2, 2) mesh."""
    mesh = meshctx.Mesh((2, 2, 2))
    assert sharding.batch_spec(mesh, 2, 8)[0] == ("pod", "data")
    assert sharding.batch_spec(mesh, 2, 2)[0] == "pod"
    assert sharding.batch_spec(mesh, 2, 3)[0] is None
    assert sharding.batch_spec(mesh, 3, 8) == sharding.P(("pod", "data"),
                                                         None, None)
    cfg = configs.get_smoke_config("dbrx-132b")
    specs = registry.param_specs(cfg)
    dense = sharding.param_shardings(specs, mesh, sharding.PARAM_RULES)
    ep = sharding.param_shardings(specs, mesh, sharding.EP_PARAM_RULES)
    assert dense["layers"]["moe"]["w_gate"].spec == sharding.P(
        None, None, "data", "model")
    assert ep["layers"]["moe"]["w_gate"].spec == sharding.P(
        None, "model", "data", None)
    assert sharding.spec_for_axes(("embed", "embed"), (8, 8), mesh,
                                  sharding.PARAM_RULES) == sharding.P(
        "data", None)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_default_mesh_sizing(n, monkeypatch):
    """The reference's sizing of n devices (its default_mesh over n of
    the host devices) is the port's of n ranks."""
    made = {}
    monkeypatch.setattr(jmeshctx.jax, "devices",
                        lambda: jax.local_devices()[:n])
    monkeypatch.setattr(jmeshctx.jax, "make_mesh",
                        lambda shape, names: made.update(shape=shape,
                                                         names=names))
    jmeshctx.default_mesh()
    assert made["names"] == AXES
    assert meshctx.default_mesh_shape(n) == tuple(made["shape"])


def test_one_rank_default_mesh_without_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = meshctx.default_mesh()
    assert mesh.axis_names == AXES and mesh.devices_shape == (1, 1, 1)
    assert mesh.group("model") is None and mesh.rank == 0
    with pytest.raises(RuntimeError):
        meshctx.make_mesh((2, 1, 1))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_rank_layout_is_row_major_as_make_mesh(shape):
    jmesh, mesh = _meshes(shape)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(mesh.size):
        c = mesh.coords(r)
        assert ids[tuple(c[a] for a in AXES)] == r
    for axes in (("pod",), ("data",), ("model",), ("pod", "data")):
        for r in range(mesh.size):
            line = mesh.line(axes, r)
            assert len(line) == mesh.axis_size(axes) and r in line
            assert line == sorted(line)


def test_production_mesh_shapes():
    got = {}

    def fake(shape, names):
        got[len(shape)] = (tuple(shape), tuple(names))

    jlaunch_mesh.jax.make_mesh, real = fake, jlaunch_mesh.jax.make_mesh
    try:
        jlaunch_mesh.make_production_mesh()
        jlaunch_mesh.make_production_mesh(multi_pod=True)
    finally:
        jlaunch_mesh.jax.make_mesh = real
    for multi in (False, True):
        shape, names = launch_mesh.production_mesh_shape(multi_pod=multi)
        assert got[len(shape)] == (shape, names)
        mesh = launch_mesh.make_production_mesh(multi_pod=multi,
                                                abstract=True)
        assert mesh.devices_shape == shape and mesh.axis_names == names
    assert launch_mesh.host_mesh_shape(2, 2, 2) == ((2, 2, 2), AXES)
    assert launch_mesh.host_mesh_shape(4, 1) == ((4, 1), ("data", "model"))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "starcoder2-3b",
                                  "qwen3-32b", "llava-next-mistral-7b"])
def test_dense_decode_state_shardings(shape, arch):
    """KV heads over model when they divide it, else the sequence, else
    replicated; slots over the batch axes."""
    jmesh, mesh = _meshes(shape)
    for get in ("get_config", "get_smoke_config"):
        jcfg, cfg = getattr(jconfigs, get)(arch), getattr(configs, get)(arch)
        for batch, seq in ((8, 64), (3, 30), (2, 6), (1, 4)):
            want = jregistry.decode_state_shardings(jcfg, jmesh, batch, seq)
            got = registry.decode_state_shardings(cfg, mesh, batch, seq)
            assert sorted(got) == sorted(want)
            for k in want:
                assert tuple(got[k].spec) == tuple(want[k].spec), (k, batch,
                                                                   seq)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b",
                                  "whisper-small"])
def test_family_decode_state_shardings(shape, arch):
    """rwkv6 (wkv by heads, the shift tokens by D), zamba2 (SSD states
    and KV rings by heads, kv_pos and pos by slots) and whisper (self and
    cross caches as the dense kinds'): every leaf's spec is the
    reference's, full and smoke configs, slots over the batch axes."""
    jmesh, mesh = _meshes(shape)
    for get in ("get_config", "get_smoke_config"):
        jcfg, cfg = getattr(jconfigs, get)(arch), getattr(configs, get)(arch)
        for batch, seq in ((8, 64), (3, 30), (2, 6), (1, 4)):
            want = jregistry.decode_state_shardings(jcfg, jmesh, batch, seq)
            got = registry.decode_state_shardings(cfg, mesh, batch, seq)
            assert sorted(got) == sorted(want)
            for k in want:
                assert tuple(got[k].spec) == tuple(want[k].spec), (k, batch,
                                                                   seq)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_shard_tensor_is_the_reference_block(shape):
    """Each rank's block under a spec is the block the reference's
    NamedSharding places on the device of the same coordinates."""
    jmesh, _ = _meshes(shape)
    x = np.arange(8 * 12 * 4, dtype=np.float32).reshape(8, 12, 4)
    specs = [sharding.P(("pod", "data"), "model", None),
             sharding.P(None, ("data", "model"), None),
             sharding.P("model", None, "data"), sharding.P(None, None)]
    for spec in specs:
        jspec = jax.sharding.PartitionSpec(*spec)
        arr = jax.device_put(x, JNamedSharding(jmesh, jspec))
        blocks = {s.device.id: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for r in range(int(np.prod(shape))):
            mesh = meshctx.Mesh(shape, rank=r)
            got = sharding.shard_tensor(torch.from_numpy(x), spec, mesh)
            np.testing.assert_array_equal(got.numpy(), blocks[r])
            assert tuple(got.shape) == sharding.shard_shape(x.shape, spec,
                                                            mesh)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_shard_tensor_holds_only_its_block(shape):
    """A rank's block is a contiguous tensor whose storage is the block's
    own bytes, whichever dims the spec splits (a block of leading rows,
    a view of the whole, would keep the whole tensor alive: every leaf a
    mesh splits along its first dim, the embedding, wo, EP_PARAM_RULES'
    experts); a spec that splits nothing returns the tensor itself."""
    x = torch.arange(8 * 12 * 4, dtype=torch.float32).reshape(8, 12, 4)
    for spec in (sharding.P(("pod", "data"), "model", None),
                 sharding.P("model", None, None), sharding.P(None, "data"),
                 sharding.P(("data", "model"))):
        for r in range(int(np.prod(shape))):
            got = sharding.shard_tensor(x, spec, meshctx.Mesh(shape, rank=r))
            assert got.is_contiguous()
            assert got.untyped_storage().nbytes() == (got.numel()
                                                      * got.element_size())
    assert sharding.shard_tensor(x, sharding.P(None, None),
                                 meshctx.Mesh(shape)) is x


def test_abstract_params_and_logical_axes():
    cfg = configs.get_config("qwen3-32b")
    specs = registry.param_specs(cfg)
    abstract = nn.abstract_params(specs)
    for (path, s), (_, t) in zip(_flat(specs), _flat(abstract)):
        assert t.device.type == "meta" and tuple(t.shape) == s.shape, path
    for (path, s), (_, a) in zip(_flat(specs), _flat(nn.logical_axes(specs))):
        assert a == s.axes, path


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_input_specs_and_batch_shardings(shape):
    """The cells' inputs (meta tensors here, ShapeDtypeStructs there) and
    their batch placement, for every architecture and cell."""
    from repro.train import steps as jsteps
    from repro_torch.train import steps

    jmesh, mesh = _meshes(shape)
    for arch in configs.ARCHS:
        jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
        for cell in configs.SHAPES:
            want = jsteps.input_specs(jcfg, cell)
            got = steps.input_specs(cfg, cell)
            assert sorted(got) == sorted(want), (arch, cell)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
                assert got[k].device.type == "meta"
            jb = jsteps.batch_shardings(jcfg, cell, jmesh)
            pb = steps.batch_shardings(cfg, cell, mesh)
            assert {k: tuple(v.spec) for k, v in pb.items()} == {
                k: tuple(v.spec) for k, v in jb.items()}


def test_prefill_and_serve_steps_are_the_registry_functions():
    from repro_torch.launch import serve as launch
    from repro_torch.train import steps

    cfg = configs.get_smoke_config("qwen1.5-0.5b").scaled(
        compute_dtype="float32")
    model = launch.build_model(cfg, 0, "cpu")
    tokens = torch.arange(12, dtype=torch.int32).reshape(2, 6) % cfg.vocab
    with torch.no_grad():
        want, (k, v) = registry.prefill_fn(cfg)(model, {"tokens": tokens})
        got, (k2, v2) = steps.build_prefill_step(cfg)(model,
                                                      {"tokens": tokens})
        assert torch.equal(got, want) and torch.equal(k2, k)
        cache = {"k": k, "v": v}
        nxt = {"tokens": tokens[:, :1]}
        want, _ = registry.serve_fn(cfg)(model, nxt, cache)
        got, _ = steps.build_serve_step(cfg)(model, nxt, cache)
        assert torch.equal(got, want)
