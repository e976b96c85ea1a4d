"""Weight bridge: the reference's parameters as the port's tensors.

``params_from_numpy`` takes the JAX package's params pytree converted to
numpy (``jax.tree.map(np.asarray, params)``: a stacked ``layers`` axis,
whose MoE sub-dict holds the router, the ``[L, E, d, f]`` experts, the
shared expert and its gate, and whose RWKV layers start at ``ln1``; or for
the hybrid a stacked ``mamba`` axis beside one ``shared`` block; ``[K, N]``
weights) and returns the same dict of torch tensors. JAX bf16
arrays arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
rejects; every float array goes through float32 (exact for bf16 and fp16)
and is cast back to its own type on the torch side. Quantized params (the
reference's ``quantize_params``, then ``jax.tree.map(np.asarray, ...)``)
carry the reference's ``QuantWeight`` nodes, recognised by their fields
(``wq``, ``scale``, ``fmt``, ``k``): their int8 codes cross byte for byte
into the port's :class:`QuantWeight`.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs import dtype_of
from .core.partition import QuantWeight
from .device import resolve_device

_QUANT_FIELDS = ("wq", "scale", "fmt", "k")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind in "iub":                               # codes, as they are
        return torch.from_numpy(np.array(a)).to(device)
    t = torch.from_numpy(np.array(a, dtype=np.float32))     # a writable copy
    return t.to(device=device, dtype=dtype_of(a.dtype.name))


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if all(hasattr(tree, f) for f in _QUANT_FIELDS):
        return QuantWeight(_tensor(tree.wq, device),
                           _tensor(tree.scale, device), tree.fmt, tree.k)
    return _tensor(tree, device)


def params_from_numpy(np_params: dict, cfg, device="cuda") -> dict:
    """Reference params (numpy leaves) -> the port's params on ``device``
    (the card unless ``"cpu"`` is asked for)."""
    if "mamba" in np_params:                    # the hybrid's mamba stack
        stacked = np_params["mamba"]["norm"]
    else:                                       # RWKV layers carry ln1
        layers = np_params["layers"]
        stacked = layers["ln1"] if "ln1" in layers else layers["attn_norm"]
    L = np.asarray(stacked).shape[0]
    if L != cfg.n_layers:
        raise ValueError(f"params hold {L} layers, {cfg.name} has "
                         f"{cfg.n_layers}")
    return _convert(np_params, resolve_device(device))
