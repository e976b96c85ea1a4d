"""The port's pipeline parallelism (distributed/pipeline.py) against the
reference's (``repro.distributed.pipeline``).

``pipeline_stats`` equals the reference's on a grid of (microbatches,
stages). Four gloo ranks (tests/torch_roofline_ranks.py, spawned once)
run ``make_pipeline_forward`` on ``test_pipeline_parallel_matches_serial``'s
tanh layers and sizes (4 stages, 8 microbatches of 2 x 16), and on 2 and
1 stages, with inputs made from a seed with numpy; each rank's outputs
match the reference's ``make_pipeline_forward`` on a host mesh of as many
devices within 1e-5 (the reference's own bound against its serial
forward). A llama3 smoke transformer block (fp32, 4 layers, 2 a stage) as
``layer_fn`` over 2 stages gives the serial forward of all 4 layers
bitwise on every rank.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_roofline_ranks as ranks
from repro.distributed.compat import set_mesh
from repro.distributed.pipeline import make_pipeline_forward as ref_pipeline
from repro.distributed.pipeline import pipeline_stats as ref_stats
from repro_torch.distributed.pipeline import pipeline_stats
from repro_torch.launch.mesh import spawn_ranks

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size steps gain nothing from intra-op threads, and the suite's
    workers share the machine's cores (each rank sets its own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def out():
    return spawn_ranks(ranks.pipeline_rank, 4, device="cpu")


@pytest.mark.parametrize("n_micro", [1, 2, 4, 8, 32])
@pytest.mark.parametrize("n_stages", [1, 2, 4, 8])
def test_pipeline_stats_match_reference(n_micro, n_stages):
    assert pipeline_stats(n_micro, n_stages) == ref_stats(n_micro, n_stages)


def test_bubble_of_two_stages_four_microbatches():
    assert pipeline_stats(4, 2) == {"ticks": 5, "bubble_fraction": 0.2}


@pytest.mark.parametrize("n_stages", ranks.STAGES)
def test_pipeline_matches_reference(out, n_stages):
    Ws, x = ranks.pipeline_inputs(n_stages)
    mesh = jax.make_mesh((n_stages,), ("stage",))

    def layer_fn(w, h):
        return jnp.tanh(h @ w[0])

    pipe = ref_pipeline(layer_fn, n_stages, ranks.N_MICRO, mesh)
    with set_mesh(mesh):
        want = np.asarray(pipe(jnp.asarray(Ws), jnp.asarray(x)))
    serial = x
    for s in range(n_stages):
        serial = np.tanh(serial @ Ws[s, 0])
    for rank, res in enumerate(out):
        got = res[n_stages].numpy()
        assert got.shape == want.shape, rank
        assert np.abs(got - want).max() < TOL, rank
        assert np.abs(got - serial).max() < TOL, rank


def test_transformer_block_pipeline_is_bitwise_serial(out):
    for rank, res in enumerate(out):
        assert res["block"].shape == res["block_serial"].shape
        assert torch.equal(res["block"], res["block_serial"]), rank
        assert torch.isfinite(res["block"]).all()
    assert torch.equal(out[0]["block_serial"], out[1]["block_serial"])
