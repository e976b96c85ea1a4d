"""Rank bodies of the port's pipeline and dry-run CPU tests
(tests/test_torch_pipeline.py, tests/test_torch_dryrun.py).

Each module spawns one gloo group of four ranks that computes all of its
cases. Imports torch and the port only, so a rank starts in seconds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.distributed.pipeline import make_pipeline_forward
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import ExampleArg, make_step_and_specs
from repro_torch.models import build_model, transformer
from repro_torch.roofline.count import count_call
from repro_torch.training.tree import tree_map

# test_pipeline_parallel_matches_serial's sizes (tests/test_distributed.py)
N_MICRO, MB, D = 8, 2, 16
STAGES = (4, 2, 1)
# the transformer block case: 2 stages of llama3's fp32 smoke layers
BLOCK_LAYERS, BLOCK_MICRO, BLOCK_MB, BLOCK_SEQ = 4, 2, 2, 16


def pipeline_inputs(n_stages: int):
    """(Ws [n_stages, 1, D, D], x [N_MICRO, MB, D]) in fp32, from a seed."""
    rng = np.random.default_rng(n_stages)
    Ws = (rng.standard_normal((n_stages, 1, D, D)) / np.sqrt(D)
          ).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    return Ws, x


def tanh_layer(w, h):
    return torch.tanh(h @ w[0])


def smoke_fp32(arch: str):
    return get_smoke_config(arch).with_(param_dtype="float32",
                                        compute_dtype="float32")


def block_case():
    """(cfg, layers, microbatches) of the transformer block case."""
    cfg = smoke_fp32("llama3-8b").with_(n_layers=BLOCK_LAYERS)
    params = build_model(cfg).init(torch.Generator().manual_seed(5),
                                   device="cpu")
    g = torch.Generator().manual_seed(6)
    x = torch.randn((BLOCK_MICRO, BLOCK_MB, BLOCK_SEQ, cfg.d_model),
                    generator=g)
    return cfg, params["layers"], x


def pipeline_rank(rank: int) -> dict:
    """The tanh pipeline at each stage count (stage dim the inner dim of a
    (4 / S, S) mesh), and the transformer block over 2 stages with its
    serial forward."""
    torch.set_num_threads(1)
    out = {}
    for n_stages in STAGES:
        mesh = init_device_mesh("cpu", (4 // n_stages, n_stages),
                                mesh_dim_names=("rep", "stage"))
        Ws, x = pipeline_inputs(n_stages)
        sid = mesh.get_local_rank("stage")
        fwd = make_pipeline_forward(tanh_layer, n_stages, N_MICRO, mesh)
        out[n_stages] = fwd(torch.from_numpy(Ws[sid:sid + 1]),
                            torch.from_numpy(x))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("rep", "stage"))
    cfg, layers, x = block_case()
    sid, per = mesh.get_local_rank("stage"), BLOCK_LAYERS // 2
    mine = tree_map(lambda a: a[sid * per:(sid + 1) * per][None], layers)
    fwd = make_pipeline_forward(
        lambda lp, h: transformer.stage_forward(lp, h, cfg), 2, BLOCK_MICRO,
        mesh)
    with torch.no_grad():
        out["block"] = fwd(mine, x)
        out["block_serial"] = torch.stack(
            [transformer.stage_forward(layers, x[m], cfg)
             for m in range(BLOCK_MICRO)])
    return out


# (name, arch, shape kind, kv_mode) of the dry-run equality cases
COUNT_CASES = (("llama3 train", "llama3-8b", "train", "auto"),
               ("llama3 decode", "llama3-8b", "decode", "auto"),
               ("zamba2 train", "zamba2-2.7b", "train", "auto"))
COUNT_SEQ, COUNT_BATCH = 64, 4


def count_shape(kind: str):
    base = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]
    return dataclasses.replace(SHAPES[base], seq_len=COUNT_SEQ,
                               global_batch=COUNT_BATCH)


def real_args(example_args):
    """Each ``ExampleArg`` as zeros of its local shape on the CPU."""
    if isinstance(example_args, ExampleArg):
        return torch.zeros(example_args.local_shape,
                           dtype=example_args.dtype)
    if isinstance(example_args, dict):
        return {k: real_args(v) for k, v in example_args.items()}
    if isinstance(example_args, (list, tuple)):
        return type(example_args)(real_args(v) for v in example_args)
    return example_args


def counted_steps_rank(rank: int) -> dict:
    """Each COUNT_CASES step on a real 2 x 2 gloo mesh, counted."""
    torch.set_num_threads(1)
    mesh = make_host_mesh(2, 2, device="cpu")
    out = {}
    for name, arch, kind, kv_mode in COUNT_CASES:
        step, args, _ = make_step_and_specs(smoke_fp32(arch), mesh,
                                            count_shape(kind),
                                            kv_mode=kv_mode)
        out[name] = count_call(step, *real_args(args))[1]
    return out
