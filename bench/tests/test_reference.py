"""The plain reference against the program's CPU path at smoke size, in
float32: prefill in several chunks with a ragged tail into the paged pool,
then decode steps reading it; for the mixture of experts also the
capacity dispatch with drops, over one call's groups and over a decode
step's lanes."""
import dataclasses

import numpy as np
import pytest
import torch

from benchkit.system import program_config
from benchkit.weights import make_weights
from reference.calls import prompt_chunks, request_calls
from reference.model import Precision, forward_logits, moe_layer
from smoke import smoke_config

BUCKETS = [16, 32]


def program(c):
    from repro_torch.models import build_model
    cfg = program_config(c, smoke=True).with_(param_dtype="float32",
                                              compute_dtype="float32")
    return cfg, build_model(cfg)


def served_logits(model, w, prompt, n_decode, block_size=8):
    """The program's logits: the prompt's chunks through paged_prefill,
    then greedy paged_decode_steps, one lane, over a fresh pool."""
    total = len(prompt) + n_decode
    nb = -(-total // block_size)
    pool = model.init_paged_cache(num_blocks=nb + 1, block_size=block_size,
                                  dtype=torch.float32, device="cpu")
    table = torch.arange(1, nb + 1)[None]
    toks = torch.from_numpy(prompt.astype(np.int64))[None]
    at = 0
    for c in prompt_chunks(len(prompt), BUCKETS):
        last, pool = model.paged_prefill(w, toks[:, at:at + c], pool,
                                         block_table=table, start_index=at)
        at += c
    rows, served = [last[0, -1]], []
    for j in range(n_decode):
        tok = rows[-1].argmax()
        served.append(int(tok))
        logits, pool = model.paged_decode_step(
            w, tok.view(1, 1), pool, block_tables=table,
            lengths=torch.tensor([len(prompt) + j]))
        rows.append(logits[0, -1])
    served.append(int(rows[-1].argmax()))
    return torch.stack(rows), served


@pytest.mark.parametrize("name", ["internlm-1.8b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("prompt_len", [75, 16, 9])
def test_prefill_then_decode_through_the_pool(name, prompt_len):
    c = smoke_config(name, torch_dtype="float32",
                     serving={"prefill_buckets": BUCKETS})
    cfg, model = program(c)
    w = make_weights(c, 11, "cpu")
    prompt = np.random.default_rng(prompt_len).integers(
        0, c["vocab_size"], prompt_len).astype(np.int32)
    got, served = served_logits(model, w, prompt, n_decode=6)
    seq = np.concatenate([prompt, np.asarray(served[:-1], np.int32)])
    ref = forward_logits(c, w, torch.from_numpy(seq.astype(np.int64)),
                         first=prompt_len - 1,
                         calls=request_calls(prompt_len, len(seq), BUCKETS))
    assert ref.shape == got.shape
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def _moe_case(group_size, seed):
    c = smoke_config("qwen2-moe-a2.7b", torch_dtype="float32")
    cfg, _ = program(c)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, group_size=group_size))
    c["assumed"] = dict(c["assumed"], moe_group_size=group_size)
    w = make_weights(c, seed, "cpu")
    lw = {k: v[0] for k, v in w["layers"]["moe"].items() if k != "shared"}
    lw["shared"] = {k: v[0] for k, v in w["layers"]["moe"]["shared"].items()}
    return c, cfg, lw


@pytest.mark.parametrize("lanes,seq,group_size", [
    (5, 1, 1024),        # one decode step of five lanes: one group
    (1, 40, 1024),       # one prompt chunk: one group
    (1, 40, 8),          # five groups of eight
    (3, 8, 6),           # a multi-lane call of 24 tokens: four groups of six
])
def test_capacity_dispatch_matches_the_program(lanes, seq, group_size):
    from repro_torch.models.moe import moe_ffn
    c, cfg, lw = _moe_case(group_size, seed=lanes * 100 + seq)
    x = torch.randn(lanes, seq, c["hidden_size"],
                    generator=torch.Generator().manual_seed(seq))
    got, _ = moe_ffn(lw, x, cfg)
    T = lanes * seq
    ref = moe_layer(x.reshape(T, -1), lw, c, [(0, T)], Precision("fp32"))
    torch.testing.assert_close(got.reshape(T, -1), ref, rtol=1e-4, atol=1e-5)


def test_the_capacity_drops_something():
    """The cases above reach the drops: some (token, choice) is dropped."""
    from reference.model import kept_assignments
    c, _, _ = _moe_case(1024, seed=0)
    experts = torch.zeros((5, 2), dtype=torch.long)
    experts[:, 1] = torch.arange(1, 6)
    keep = kept_assignments(experts, [(0, 5)], c)
    # capacity of a 5-token group: max(2, ceil(5 / 6 * 1.25 * 2)) = 3
    assert keep[:, 0].tolist() == [True, True, True, False, False]
    assert keep[:, 1].all()
