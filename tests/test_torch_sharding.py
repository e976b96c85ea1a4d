"""The port's sharding rules (distributed/sharding.py) and production mesh
(launch/mesh.py) against the reference's.

``param_specs`` must equal the reference's leaf for leaf for every
assigned smoke config, with and without FSDP, on the reference's 2 x 4
host mesh and on the production shapes (16 x 16, 2 x 16 x 16), drops
included; ``cache_specs`` in all three KV modes; ``sanitize_spec`` on the
reference's cases, with its one-time warning. The port's meshes are
``DeviceMesh``es over a fake process group
(``torch.testing._internal.distributed.fake_pg``), one process holding
rank 0 of 8, 256 or 512; the reference's production mesh is a plain
object with ``.shape`` and ``.axis_names``, which is all its rules read.
"""
import contextlib
import warnings

import jax
import pytest
import torch
import torch.distributed as dist

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_smoke_config as ref_smoke_config
from repro.distributed import sharding as ref
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import _meta_tree, param_shapes
from repro_torch.models import build_model
from repro_torch.training.tree import tree_flatten

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def fake_group(world: int):
    """Rank 0 of a ``world``-rank fake process group, destroyed after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def port_mesh(name: str):
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = MESHES[name]
    with fake_group(int(torch.tensor(shape).prod())):
        yield init_device_mesh("cpu", shape, mesh_dim_names=axes)


class _RefMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes


def ref_mesh(name: str):
    if name == "2x4":
        return ref_host_mesh(2, 4)
    return _RefMesh(*MESHES[name])


def norm(spec) -> tuple:
    """A spec (a PartitionSpec or the port's tuple) as per-dim tuples of
    axis names, trailing empties dropped."""
    out = [() if e is None else ((e,) if isinstance(e, str) else tuple(e))
           for e in spec]
    while out and not out[-1]:
        out.pop()
    return tuple(out)


def ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(p.key) for p in path): norm(s) for path, s in flat}


def port_flat(tree) -> dict:
    return {"/".join(p): norm(s) for p, s in tree_flatten(tree)}


@pytest.mark.parametrize("fsdp", (True, False), ids=("fsdp", "serve"))
@pytest.mark.parametrize("mesh", tuple(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_match_reference(arch, mesh, fsdp):
    model = ref_build_model(ref_smoke_config(arch))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_flat(ref.param_specs(shapes, ref_mesh(mesh), fsdp=fsdp))
        with port_mesh(mesh) as m:
            got = port_flat(sharding.param_specs(
                param_shapes(build_model(get_smoke_config(arch))), m,
                fsdp=fsdp))
    assert got == want


@pytest.mark.parametrize("kv_mode", ("head", "seq", "auto"))
@pytest.mark.parametrize("arch", ("llama3-8b", "smollm-135m",
                                  "qwen2-moe-a2.7b", "zamba2-2.7b",
                                  "rwkv6-3b"))
def test_cache_specs_match_reference(arch, kv_mode):
    rcfg = ref_smoke_config(arch)
    rmodel = ref_build_model(rcfg)
    shapes = jax.eval_shape(lambda: rmodel.init_cache(batch=4, max_len=64))
    model = build_model(get_smoke_config(arch))
    cache = _meta_tree(lambda device: model.init_cache(
        batch=4, max_len=64, device=device))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_flat(ref.cache_specs(shapes, ref_host_mesh(2, 4), rcfg,
                                        kv_mode=kv_mode))
        with port_mesh("2x4") as m:
            got = port_flat(sharding.cache_specs(
                cache, m, get_smoke_config(arch), kv_mode=kv_mode))
    assert got == want


def test_sanitize_spec():
    """The reference's three cases (tests/test_distributed.py), the
    dropped dims and the one-time warning."""
    with port_mesh("2x4") as m:                  # model axis = 4
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert sharding.sanitize_spec(("model",), (503,), m) == ()
            assert sharding.sanitize_spec(("model",), (512,), m) == \
                ("model",)
            assert sharding.sanitize_spec((("data",), "model"), (1, 8),
                                          m) == (None, "model")
        dropped = []
        with pytest.warns(sharding.ShardingDropWarning):
            assert sharding.sanitize_spec(("data", "model"), (6, 1001), m,
                                          dropped=dropped) == ("data",)
        assert dropped == [1]
        with warnings.catch_warnings():
            warnings.simplefilter("error")      # the same drop: no warning
            dropped = []
            sharding.sanitize_spec(("data", "model"), (6, 1001), m,
                                   dropped=dropped)
        assert dropped == [1]


@pytest.mark.parametrize("mesh", tuple(MESHES))
def test_batch_and_hidden_specs_match_reference(mesh):
    rm = ref_mesh(mesh)
    with port_mesh(mesh) as m:
        for shape in ((1, 64), (4, 64), (64, 64, 8)):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                want = ref.sanitize_spec(ref.batch_spec(rm, len(shape)),
                                         shape, rm)
                got = sharding.batch_sharding(m, shape).spec
            assert norm(got) == norm(want), shape
        assert sharding.batch_sharding(m, (1, 64)).spec == ()
        for sp in (True, False):
            assert norm(sharding.hidden_spec(m, seq_shard=sp)) == \
                norm(ref.hidden_spec(rm, seq_shard=sp))


def test_named_sharding_local_shape():
    with port_mesh("2x16x16") as m:
        ns = sharding.NamedSharding(m, (None, ("pod", "data"), "model"))
        assert ns.local_shape((3, 64, 32)) == (3, 2, 2)
        assert sharding.NamedSharding(m, ()).local_shape((5, 7)) == (5, 7)


def _local_of(shape, spec, sizes) -> tuple:
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        for a in norm((e,))[0] if e is not None else ():
            dim //= sizes[a]
        out.append(dim)
    return tuple(out)


@pytest.mark.parametrize("arch,shape", (
    ("llama3-8b", "train_4k"), ("llama3-8b", "decode_32k"),
    ("qwen2-moe-a2.7b", "train_4k"), ("zamba2-2.7b", "decode_32k"),
    ("hubert-xlarge", "prefill_32k")))
def test_step_example_args_at_production_shape(arch, shape):
    """``make_step_and_specs`` of a full-size config on the 16 x 16
    production mesh builds without allocating: every example argument's
    local shape is its global shape divided by its spec's axes, and its
    ``meta()`` block holds no data (what a dry run traces)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.steps import ExampleArg, make_step_and_specs
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with port_mesh("16x16") as m:
            step, args, act = make_step_and_specs(get_config(arch), m,
                                                  SHAPES[shape])
            sizes = sharding.mesh_sizes(m)
            leaves = [leaf for tree in args
                      for _, leaf in tree_flatten(tree)]
            assert leaves and all(isinstance(a, ExampleArg) for a in leaves)
            for a in leaves:
                assert a.local_shape == _local_of(a.shape, a.spec, sizes), a
                t = a.meta()
                assert t.is_meta and tuple(t.shape) == a.local_shape
            assert act == sharding.hidden_spec(
                m, seq_shard=SHAPES[shape].kind != "decode")


@pytest.mark.parametrize("multi_pod", (False, True), ids=("pod", "2pods"))
def test_make_production_mesh(multi_pod):
    world = 512 if multi_pod else 256
    with fake_group(world):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                       else ("data", "model"))
    with fake_group(world // 2):
        with pytest.raises(ValueError, match="needs"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")
