"""Weight quantization for serving: fp params -> params carrying QuantWeights.

``quantize_params`` rewrites the dense transformer's matmul sites
(attention q/k/v/o, SwiGLU gate/up/down and an untied LM head) into
:class:`repro_torch.core.partition.QuantWeight` containers, int8 or packed
int4 codes with per-output-channel scales; embeddings and norms stay fp.
The stacked ``[L, ...]`` layer axis stays, so the layer loop slices a
QuantWeight per layer as it slices a tensor. Under a HeteroCtx the aligned
path launches the dequantizing GEMMs; everywhere else the weight is
dequantized before the product, so every schedule sees the same weight
values. A tied LM head stays fp: it is the embedding's transpose.

``score_nll`` of the reference waits for the port of ``model.loss``.
"""
from __future__ import annotations

import torch

from ..core.partition import QuantWeight
from ..kernels.hetero_matmul.ops import quantize_weight, quantize_weight_int4

WEIGHT_FORMATS = ("int8", "w4a16")

_ATTN_SITES = ("wq", "wk", "wv", "wo")
_FFN_SITES = ("w_gate", "w_up", "w_down")


def _quantize_leaf(w: torch.Tensor, fmt: str) -> QuantWeight:
    """Quantize ``[K, N]`` or a stack ``[L, K, N]`` one layer at a time, so
    the fp32 temporaries never exceed one layer's size (a stacked
    llama3-8b w_gate in fp32 would be 7.5 GB). Per-column arithmetic, so
    per-layer results are the stacked ones byte for byte."""
    qfn = quantize_weight if fmt == "int8" else quantize_weight_int4
    k = w.shape[-2]
    if w.ndim == 2:
        wq, scale = qfn(w)
        return QuantWeight(wq, scale, fmt, k)
    L, _, N = w.shape
    wq = torch.empty((L, -(-k // 2) if fmt == "w4a16" else k, N),
                     dtype=torch.int8, device=w.device)
    scale = torch.empty((L, N), dtype=torch.float32, device=w.device)
    for i in range(L):
        wq[i], scale[i] = qfn(w[i])
    return QuantWeight(wq, scale, fmt, k)


def quantize_params(params: dict, cfg, fmt: str) -> dict:
    """A copy of ``params`` with every dense matmul site quantized to
    ``fmt`` ('int8' or 'w4a16'); the fp tensors are shared, not copied."""
    if fmt not in WEIGHT_FORMATS:
        raise ValueError(f"unsupported weight quant format {fmt!r}; "
                         f"expected one of {WEIGHT_FORMATS}")
    if cfg.family != "dense":
        raise NotImplementedError("weight quantization covers the dense "
                                  f"transformer family only (got "
                                  f"{cfg.family!r})")
    out = dict(params)
    layers = dict(params["layers"])
    layers["attn"] = dict(layers["attn"])
    for site in _ATTN_SITES:
        layers["attn"][site] = _quantize_leaf(layers["attn"][site], fmt)
    layers["ffn"] = dict(layers["ffn"])
    for site in _FFN_SITES:
        layers["ffn"][site] = _quantize_leaf(layers["ffn"][site], fmt)
    out["layers"] = layers
    if "head" in params:
        out["head"] = _quantize_leaf(params["head"], fmt)
    return out


def dequantize_params(params: dict) -> dict:
    """Every QuantWeight expanded back to an fp32 tensor: the dequantize-
    then-fp arm quantized execution is compared against."""
    if isinstance(params, dict):
        return {k: dequantize_params(v) for k, v in params.items()}
    if isinstance(params, QuantWeight):
        return params.dequant(torch.float32)
    return params
