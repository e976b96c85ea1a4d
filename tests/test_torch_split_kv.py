"""The port's split-KV decode over a mesh (distributed/split_kv.py), its
softmax combine, ``compressed_psum`` (distributed/compression.py) and
``tp_all_gather`` against the reference's.

Split-KV decode runs on four gloo ranks twice, over a 1 x 4 and a
data 2 x model 2 mesh, at positions 0, 15, 16, 37 and 63 (shard
boundaries included); each rank's output and cache blocks are held to the
reference's ``split_kv_decode_update_attend`` over a host mesh of the same
shape on the same numpy inputs: outputs within 1e-5, cache writes bitwise.
The combine is held to the reference's on ragged lengths, locally and over
the 4-rank model group; ``compressed_psum`` to the reference's over a
4-device mesh. The ranks start once for the module
(tests/torch_tp_ranks.py) and run every case.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_tp_ranks as ranks
from repro.distributed.compat import set_mesh, shard_map
from repro.distributed.compression import compressed_psum as ref_psum
from repro.distributed.split_kv import \
    combine_split_softmax as ref_combine
from repro.distributed.split_kv import \
    split_kv_decode_update_attend as ref_split_kv
from repro.launch.mesh import make_host_mesh as ref_mesh
from repro_torch.distributed.sharding import (split_kv_active,
                                              split_kv_enabled,
                                              undivided_dims)
from repro_torch.distributed.split_kv import (combine_split_softmax,
                                              local_shard,
                                              split_kv_decode_update_attend)
from repro_torch.launch.mesh import spawn_ranks

TOL = 1e-5
WORLD = 4
MESHES = ((1, 4), (2, 2))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks_out():
    return spawn_ranks(ranks.split_kv_rank, WORLD, device="cpu")


@pytest.fixture(scope="module")
def ref_split():
    """The reference's split-KV step per (mesh shape, position): (out,
    new k cache, new v cache) as numpy."""
    q, kn, vn, kc, vc = (jnp.asarray(a) for a in ranks.split_kv_inputs())
    jf = jax.jit(ref_split_kv)
    out = {}
    for shape in MESHES:
        mesh = ref_mesh(*shape)
        for pos in ranks.SPLIT_KV_POSITIONS:
            with set_mesh(mesh):
                res = jf(q, kn, vn, kc, vc, jnp.asarray(pos, jnp.int32))
            out[shape, pos] = tuple(np.asarray(a) for a in res)
    return out


def _block(a, shape, rank):
    """Rank ``rank``'s block of a full [B, S, ...] array on a
    ``(data, model)`` mesh of ``shape``: batch over data, sequence over
    model (row-major ranks)."""
    data, model = shape
    i, j = divmod(rank, model)
    b, s = a.shape[0] // data, a.shape[1] // model
    return a[i * b:(i + 1) * b, j * s:(j + 1) * s]


@pytest.mark.parametrize("pos", ranks.SPLIT_KV_POSITIONS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_split_kv_matches_reference(ranks_out, ref_split, shape, pos):
    want_o, want_k, want_v = ref_split[shape, pos]
    for rank in range(WORLD):
        o, ck, cv = ranks_out[rank]["split_kv"][shape, pos]
        data, model = shape
        b = want_o.shape[0] // data
        i = rank // model
        np.testing.assert_allclose(o, want_o[i * b:(i + 1) * b], atol=TOL,
                                   rtol=0)
        np.testing.assert_array_equal(ck, _block(want_k, shape, rank))
        np.testing.assert_array_equal(cv, _block(want_v, shape, rank))


def test_split_kv_one_shard_matches_reference():
    """``mesh=None``: one shard holds the whole cache (written in place)."""
    q, kn, vn, kc, vc = ranks.split_kv_inputs()
    t = [torch.from_numpy(a.copy()) for a in (q, kn, vn, kc, vc)]
    jf = jax.jit(ref_split_kv)
    with set_mesh(ref_mesh(1, 1)):
        for pos in (0, 37, 63):
            want = jf(*(jnp.asarray(a) for a in (q, kn, vn, kc, vc)),
                      jnp.asarray(pos, jnp.int32))
            ck, cv = t[3].clone(), t[4].clone()
            o, ck2, cv2 = split_kv_decode_update_attend(
                *t[:3], ck, cv, torch.tensor(pos))
            assert ck2 is ck
            np.testing.assert_allclose(o.numpy(), np.asarray(want[0]),
                                       atol=TOL, rtol=0)
            np.testing.assert_array_equal(ck.numpy(), np.asarray(want[1]))


def test_split_kv_indivisible_smax_raises():
    """Smax = 66 on a 4-wide model axis: the trailing slots would never be
    attended over; cutting the cache raises the reference's message."""
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(1, 4), get_local_rank=lambda n: 0)
    with pytest.raises(ValueError, match="not divisible"):
        local_shard(torch.zeros(4, 66, 2, 16), mesh)
    assert undivided_dims((4, 66, 2, 16), (None, "model", None, None),
                          mesh) == [1]
    assert undivided_dims((4, 64), ("data", "model"), mesh) == []


def test_combine_split_softmax_local_matches_reference():
    s, v = ranks.combine_inputs()
    want = np.asarray(ref_combine(jnp.asarray(s), jnp.asarray(v)))
    got = combine_split_softmax(torch.from_numpy(s), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_combine_split_softmax_over_ranks_matches_reference(ranks_out):
    s, v = ranks.combine_inputs()
    mesh = jax.make_mesh((4,), ("model",))
    want = np.asarray(shard_map(
        lambda sl, vl: ref_combine(sl, vl, "model"), mesh=mesh,
        in_specs=(P(None, None, None, "model"), P(None, "model")),
        out_specs=P(), check_vma=False)(jnp.asarray(s), jnp.asarray(v)))
    for rank in range(WORLD):
        np.testing.assert_allclose(ranks_out[rank]["combine"], want,
                                   atol=TOL, rtol=0)


def test_compressed_psum_matches_reference(ranks_out):
    """Within 1e-6 of the reference's, the same int codes (the sum over the
    ranks' codes times the shared step), and within the int8 bound of the
    exact sum."""
    x = ranks.psum_input()
    mesh = jax.make_mesh((4,), ("d",))
    want = np.asarray(jax.jit(shard_map(
        lambda xs: ref_psum(xs, "d"), mesh=mesh, in_specs=P("d"),
        out_specs=P("d")))(jnp.asarray(x)))
    step = max(np.abs(x).max() / 127.0, 1e-30)     # amax / 127 (scale / n)
    for rank in range(WORLD):
        got = ranks_out[rank]["psum"]
        np.testing.assert_allclose(got, want[rank:rank + 1], atol=1e-6,
                                   rtol=0)
        np.testing.assert_array_equal(np.rint(got / step),
                                      np.rint(want[rank:rank + 1] / step))
    exact = x.sum(0, keepdims=True)
    rel = np.abs(ranks_out[0]["psum"] - exact).max() / np.abs(exact).max()
    assert rel < 0.05


def test_tp_all_gather_rank_order(ranks_out):
    """Rank r's slice [r, r+1, r+2] lands at columns 3r..3r+2 on every
    rank."""
    want = np.concatenate([np.full((2, 1, 3), float(r)) + np.arange(3.0)
                           for r in range(WORLD)], axis=-1)
    for rank in range(WORLD):
        np.testing.assert_array_equal(ranks_out[rank]["gather"], want)


def test_split_kv_switch_is_context_local():
    """``split_kv_enabled`` is a context variable: two interleaved
    contexts each see their own setting, the root context none."""
    import contextvars
    a, b = contextvars.copy_context(), contextvars.copy_context()
    cm = split_kv_enabled(True)
    b.run(cm.__enter__)
    assert a.run(split_kv_active) is False and b.run(split_kv_active) is True
    b.run(cm.__exit__, None, None, None)
    assert b.run(split_kv_active) is False and split_kv_active() is False


def test_attention_takes_split_kv_branch(smoke_model):
    """A dense-cache decode step under ``split_kv_enabled(True)`` (one
    shard) gives the decode kernel path's logits within 1e-5; the first
    layer writes the same cache bytes (later layers' K/V follow the
    attention outputs, within 1e-5); prefill (S > 1) is unaffected by the
    switch."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import build_model
    cfg = ranks.smoke_cfg()
    params = params_from_numpy(jax.tree.map(np.asarray, smoke_model[2]),
                               cfg, "cpu")
    model = build_model(cfg)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, 9)))
    caches = []
    for split in (False, True):
        cache = model.init_cache(2, 32, torch.float32, device="cpu")
        with split_kv_enabled(split):
            _, cache = model.prefill(params, prompt, cache)
            logits, cache = model.decode_step(params, prompt[:, -1:], cache)
        caches.append((logits, cache))
    (want, wc), (got, gc) = caches
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    for name in ("k", "v"):
        assert torch.equal(gc[name][0], wc[name][0])
        np.testing.assert_allclose(gc[name].numpy(), wc[name].numpy(),
                                   atol=TOL, rtol=0)
