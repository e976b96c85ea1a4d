"""The port's tensor-parallel paged serving (serving/layout.py) against its
single-device batcher and the reference's.

``MeshLayout`` splits every matrix on its output axis and gathers the
slices in rank order, so TP is an execution schedule: the greedy streams of
the TP = 2 batcher (four gloo ranks, a data 2 x model 2 mesh: two replicas
of the TP pair) must equal the single-device port's bit for bit on all
eight of the reference's arms (tests/test_tp_serving.py's ARMS), with the
same counters and a drained pool on every rank; on host and device they
also equal the reference's ``PagedBatcher`` tokens. TP = 4 runs on the
``n_kv_heads=4`` smoke variant. Placement is checked per rank, the
reference's quantized params slice to its own shard shapes, and the
reference's validation errors are raised. The ranks start once for the
module (tests/torch_tp_ranks.py) and run every case; each test reads its
case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks as ranks
from repro.models.quant import quantize_params as ref_quantize_params
from repro.serving.scheduler import PagedBatcher as RefPagedBatcher
from repro.serving.scheduler import Request as RefRequest
from repro_torch.convert import params_from_numpy
from repro_torch.launch.mesh import spawn_ranks

WORLD = 4
TP = 2
REF_ARMS = ("host", "device")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The smoke-size steps gain nothing from intra-op threads, and the
    suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module (each rank sets its own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(smoke_model):
    """(cfg, the reference's smoke params converted to the port)."""
    cfg = ranks.smoke_cfg()
    return cfg, params_from_numpy(jax.tree.map(np.asarray, smoke_model[2]),
                                  cfg, "cpu")


@pytest.fixture(scope="module")
def ref_quant(smoke_model):
    """The reference's W4A16 params as numpy, and converted."""
    cfg, _, params = smoke_model
    q = jax.tree.map(np.asarray, ref_quantize_params(params, cfg, "w4a16"))
    return q, params_from_numpy(q, ranks.smoke_cfg(), "cpu")


@pytest.fixture(scope="module")
def tp(port, ref_quant):
    """Every rank's results, from one spawn of the module's ranks."""
    return spawn_ranks(ranks.tp_serving_rank, WORLD, port[1], ref_quant[1],
                       device="cpu")


@pytest.fixture(scope="module")
def single(port):
    """The single-device port's (tokens, stats) per arm, on first use."""
    done = {}

    def run(arm):
        if arm not in done:
            done[arm] = ranks.serve(*port, **ranks.ARMS[arm])
        return done[arm]
    return run


def _without_tp(stats):
    return {k: v for k, v in stats.items() if k not in ("tp", "captured")}


@pytest.mark.parametrize("arm", sorted(ranks.ARMS))
def test_tp2_arms_equal_single_device(tp, single, arm):
    want, want_stats = single(arm)
    assert want_stats["tp"] == 1
    for rank in range(WORLD):
        got, stats = tp[rank]["arms"][arm]
        assert got == want, (arm, rank)
        assert stats["tp"] == TP and stats["captured"] is False
        assert _without_tp(stats) == _without_tp(want_stats), (arm, rank)
    if arm == "spec_self":
        assert want_stats["verify_dispatches"] > 0
        assert 0.0 <= want_stats["acceptance_rate"] <= 1.0


@pytest.mark.parametrize("arm", REF_ARMS)
def test_tp2_equals_reference(smoke_model, tp, arm):
    cfg, _, params = smoke_model
    kw = {k: v for k, v in ranks.POOL.items() if k != "cache_dtype"}
    b = RefPagedBatcher(cfg, params, cache_dtype=jnp.float32, **kw,
                        **ranks.ARMS[arm])
    reqs = [RefRequest(rid=i, prompt=p, max_new_tokens=ranks.N_NEW)
            for i, p in enumerate(ranks.prompts(cfg))]
    b.run(reqs)
    want = {r.rid: tuple(r.output) for r in reqs}
    for rank in range(WORLD):
        assert tp[rank]["arms"][arm][0] == want, rank


@pytest.mark.parametrize("arm", ranks.TP4_ARMS)
def test_tp4_equals_single_device(tp, arm):
    want, _ = ranks.serve(*ranks.tp4_params(), **ranks.ARMS[arm])
    for rank in range(WORLD):
        got, stats = tp[rank]["tp4"][arm]
        assert got == want and stats["tp"] == 4, rank


def test_tp_prefix_replay(tp, single):
    """A second prefix-cache run over the sharded pool (warm hits, the CoW
    path) gives the cold run's tokens."""
    want = single("prefix_cache")[0]
    for rank in range(WORLD):
        assert tp[rank]["prefix_replay"] == want


def test_tp_placement_per_rank(port, tp):
    """Column-sharded sites hold this rank's contiguous slice of the last
    axis (in rank order on the model axis); embed, norms and the int8 scale
    planes replicate, shared with the caller's params; the pool holds the
    local KV heads."""
    cfg, params = port
    full = dict(ranks._leaves(params))
    L = cfg.n_layers
    for rank in range(WORLD):
        pl = tp[rank]["placement"]
        r = pl["rank"]
        assert r == rank % TP and pl["tp"] == TP
        assert pl["capturable"] is False               # gloo
        assert pl["head_dim"] == cfg.head_dim
        shapes, plan = pl["shapes"], pl["plan"]
        for site in ("attn/wq", "attn/wo", "ffn/w_gate", "ffn/w_down"):
            path = f"layers/{site}"
            assert plan[path] is True
            K, N = full[path].shape[1:]
            assert shapes[path] == (L, K, N // TP), path
        n = full["layers/attn/wq"].shape[-1] // TP
        np.testing.assert_array_equal(
            pl["wq"], full["layers/attn/wq"][..., r * n:(r + 1) * n].numpy())
        replicated = [p for p in shapes
                      if p == "embed" or p.endswith("norm")]
        assert "embed" in replicated and "final_norm" in replicated
        for path in replicated:
            assert plan[path] is False and pl["shares_full"][path], path
            assert shapes[path] == tuple(full[path].shape)
        if cfg.tie_embeddings:
            assert "head" not in plan
        else:
            assert plan["head"] is True
            assert shapes["head"] == (cfg.d_model, cfg.vocab_size // TP)
        pool = pl["pool"]
        assert pool["k"] == (L, 40, ranks.BS, cfg.n_kv_heads // TP,
                             cfg.head_dim)
        assert pool["v"] == pool["k"]
        assert pool["k_scale"] == pool["v_scale"] == (L, 40, ranks.BS)


def test_tp_slices_reference_quant_weights(ref_quant, tp):
    """The reference's W4A16 params, converted, slice to the reference's
    own shard shapes (codes and scales along N: the nibble packing along K
    is never cut), each rank its contiguous block of the reference's
    arrays."""
    q, _ = ref_quant
    for rank in range(WORLD):
        r = rank % TP
        for path, got in tp[rank]["quant"].items():
            node = q
            parts = path.split("/")
            for key in parts[:-1]:
                node = node[key] if isinstance(node, dict) else node
            want = np.asarray(getattr(node, parts[-1]))
            n = want.shape[-1] // TP
            assert got.shape == want.shape[:-1] + (n,), path
            np.testing.assert_array_equal(got,
                                          want[..., r * n:(r + 1) * n])
    assert {p.rsplit("/", 1)[0] for p in tp[0]["quant"]} >= {
        "layers/attn/wq", "layers/ffn/w_down"}


def test_tp_validation_errors(tp):
    errors = tp[0]["errors"]
    assert "n_kv_heads" in errors["n_kv_heads"]            # 2 heads, 4 ranks
    assert "mutually exclusive" in errors["engine_mode"]
    assert "model" in errors["no_model_axis"]
    assert "HeteroCtx" in errors["hetero_ctx"]
    assert "dense transformer family" in errors["family"]
