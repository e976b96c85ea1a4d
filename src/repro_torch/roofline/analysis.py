"""Roofline analysis over the dry-run records, the port of
``repro.roofline.analysis`` for the H100.

Per (arch x shape x mesh), from ``launch/dryrun.py``'s records:
  compute term    = FLOPs / peak FLOPs          (a rank's count)
  memory term     = bytes accessed / HBM rate
  collective term = sum over collectives of ring-traffic(bytes, group) /
                    the group's link rate

The reference charges every group one torus rate (``ici_bw x
ici_links``). An H100 cluster has two tiers, so on a ``GPUSpec`` with a
network rate (``H100``) a group of at most ``node_size`` ranks (one 8-GPU
node) is charged NVLink (``ici_bw x ici_links``, 18 x 25 GB/s) and a larger
group the node's network share a GPU (``net_bw``, 50 GB/s); a ``TPUSpec``
(``V5E``) is charged as the reference charges it, so the two modules agree
field for field on the same records.

A record of the port's dry run counts every layer (an eager trace,
``"counted_by": "trace"``): its note reads ``trace``. A record without
that key is the reference's (a scanned program whose while bodies XLA's
cost analysis counts once), and takes the reference's probe-pair
correction when both probes are there:
    total = probe1 + (units - 1) * (probe2 - probe1)
where a "unit" is a layer (or a zamba period), else its raw numbers, noted
``scan-raw(undercounted)``.

MODEL_FLOPS sanity: 6*N_active*tokens (train) / 2*N_active*tokens (serve);
the ratio MODEL_FLOPS / counted FLOPs exposes remat, recomputation,
replicated work and padding. A record may carry its own shape
(``shape_spec``: seq_len, global_batch, kind) for a cell outside
``SHAPES``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from ..configs import SHAPES, get_config
from ..configs.base import ShapeSpec
from ..core.characteristics import H100, V5E

HBM_PER_CHIP = 80 * 10 ** 9          # H100 SXM5 80GB

RING_FACTORS = {    # effective bytes-on-wire multiplier given parsed result size
    "all-reduce": lambda n: 2 * (n - 1) / max(n, 1),
    "all-gather": lambda n: (n - 1) / max(n, 1),
    "reduce-scatter": lambda n: (n - 1),
    "all-to-all": lambda n: (n - 1) / max(n, 1),
    "collective-permute": lambda n: 1.0,
}


def _units(cfg) -> int:
    if cfg.ssm is not None:
        return cfg.n_layers // cfg.ssm.attn_every
    return cfg.n_layers


def _load(out_dir: Path, cell: str) -> Optional[dict]:
    p = out_dir / f"{cell}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def _link_rate(spec, group: int) -> float:
    """Bytes a second on the links that carry a collective over ``group``
    ranks: NVLink within a node, the network beyond it (see the module's
    docstring); the torus rate on a spec without a network rate."""
    net = getattr(spec, "net_bw", 0.0)
    if net and group > spec.node_size:
        return net
    return spec.ici_bw * spec.ici_links


def _coll_seconds(coll: dict, spec=V5E) -> float:
    t = 0.0
    for op, rec in coll.items():
        group = rec.get("group", 1)
        f = RING_FACTORS.get(op, lambda n: 1.0)(group)
        t += rec["bytes"] * f / _link_rate(spec, group)
    return t


def _coll_bytes(coll: dict) -> float:
    return sum(rec["bytes"] for rec in coll.values())


def _combine(base: dict, p1: dict, p2: dict, units: int, spec=V5E) -> dict:
    """Recover true per-device totals from the probe pair."""
    scale = p1.get("probe_seq_scale", 1.0)

    def field(v1, v2):
        # probe1 = 1 unit (+ embed/head), probe2 = 2 units -> delta = 1 unit
        return v1 + (units - 1) * (v2 - v1)

    flops = field(p1["cost"]["flops"], p2["cost"]["flops"]) * scale
    nbytes = field(p1["cost"]["bytes accessed"],
                   p2["cost"]["bytes accessed"]) * scale
    cb1, cb2 = _coll_bytes(p1["collectives"]), _coll_bytes(p2["collectives"])
    cs1 = _coll_seconds(p1["collectives"], spec)
    cs2 = _coll_seconds(p2["collectives"], spec)
    coll_bytes = field(cb1, cb2) * scale
    coll_s = field(cs1, cs2) * scale
    return {"flops": flops, "bytes": nbytes, "coll_bytes": coll_bytes,
            "coll_s": coll_s}


@dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    ok: bool
    skipped: bool = False
    reason: str = ""
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    model_flops: float = 0.0
    hlo_flops_global: float = 0.0
    useful_ratio: float = 0.0
    hbm_gb_per_chip: float = 0.0
    dominant: str = ""
    bound_time_s: float = 0.0
    roofline_fraction: float = 0.0
    note: str = ""

    def row(self) -> str:
        if self.skipped:
            return (f"| {self.arch} | {self.shape} | — | — | — | — | — | "
                    f"SKIP: {self.reason} |")
        return (f"| {self.arch} | {self.shape} | {self.compute_s*1e3:.2f} | "
                f"{self.memory_s*1e3:.2f} | {self.collective_s*1e3:.2f} | "
                f"{self.dominant} | {self.useful_ratio:.2f} | "
                f"{self.roofline_fraction:.2f} | {self.note} |")


def _shape_of(shape_name: str, rec: Optional[dict] = None) -> ShapeSpec:
    spec = (rec or {}).get("shape_spec")
    if spec:
        return ShapeSpec(shape_name, spec["seq_len"], spec["global_batch"],
                         spec["kind"])
    return SHAPES[shape_name]


def model_flops_for(arch: str, shape_name: str, *,
                    shape: Optional[ShapeSpec] = None) -> float:
    cfg = get_config(arch)
    shape = shape or SHAPES[shape_name]
    n = cfg.n_params_active
    if shape.kind == "train":
        toks = shape.seq_len * shape.global_batch
        return 6.0 * n * toks
    if shape.kind == "prefill":
        toks = shape.seq_len * shape.global_batch
        return 2.0 * n * toks
    return 2.0 * n * shape.global_batch          # decode: one token per seq


def analyze_cell(arch: str, shape_name: str, *, mesh: str = "pod16x16",
                 out_dir: str | Path = "artifacts/dryrun_torch",
                 spec=H100) -> CellRoofline:
    out_dir = Path(out_dir)
    base = _load(out_dir, f"{arch}__{shape_name}__{mesh}")
    cell = CellRoofline(arch=arch, shape=shape_name, mesh=mesh, ok=False)
    if base is None:
        cell.reason = "missing artifact"
        return cell
    if base.get("skipped"):
        cell.skipped, cell.reason, cell.ok = True, base["reason"], True
        return cell
    if not base.get("ok"):
        cell.reason = base.get("error", "failed")
        return cell

    cfg = get_config(arch)
    p1 = _load(out_dir, f"{arch}__{shape_name}__pod16x16__probe1")
    p2 = _load(out_dir, f"{arch}__{shape_name}__pod16x16__probe2")
    n_dev = base.get("n_devices", 256)
    mem = base.get("memory", {})
    cell.hbm_gb_per_chip = (mem.get("argument_size_in_bytes", 0)
                            + mem.get("temp_size_in_bytes", 0)
                            + mem.get("output_size_in_bytes", 0)
                            - mem.get("alias_size_in_bytes", 0)) / 2 ** 30

    if p1 and p2 and p1.get("ok") and p2.get("ok"):
        tot = _combine(base, p1, p2, _units(cfg), spec)
        src = "probe-pair"
    else:   # the record's own numbers: exact for a trace
        tot = {"flops": base["cost"]["flops"],
               "bytes": base["cost"]["bytes accessed"],
               "coll_bytes": _coll_bytes(base["collectives"]),
               "coll_s": _coll_seconds(base["collectives"], spec)}
        src = ("trace" if base.get("counted_by") == "trace"
               else "scan-raw(undercounted)")

    shape = _shape_of(shape_name, base)
    cell.compute_s = tot["flops"] / spec.peak_flops_bf16
    cell.memory_s = tot["bytes"] / spec.hbm_bw
    cell.collective_s = tot["coll_s"]
    cell.model_flops = model_flops_for(arch, shape_name, shape=shape)
    cell.hlo_flops_global = tot["flops"] * n_dev
    cell.useful_ratio = (cell.model_flops / cell.hlo_flops_global
                         if cell.hlo_flops_global else 0.0)
    terms = {"compute": cell.compute_s, "memory": cell.memory_s,
             "collective": cell.collective_s}
    cell.dominant = max(terms, key=terms.get)
    cell.bound_time_s = max(terms.values())
    # roofline fraction: the cell's physical lower bound over the dominant
    # term. Decode is bandwidth-bound by nature: its bound is streaming the
    # weights + cache once per token, not the (trivial) matvec FLOPs.
    ideal_s = cell.model_flops / (n_dev * spec.peak_flops_bf16)
    if shape.kind == "decode":
        w_bytes = cfg.n_params_active * 2
        if cfg.rwkv is not None:
            state = cfg.n_layers * shape.global_batch * cfg.d_model * \
                cfg.rwkv.head_dim * 4
        elif cfg.ssm is not None:
            d_in = cfg.ssm.expand * cfg.d_model
            nh = d_in // cfg.ssm.head_dim
            state = cfg.n_layers * shape.global_batch * nh * \
                cfg.ssm.head_dim * cfg.ssm.d_state * 4
            state += (cfg.n_layers // cfg.ssm.attn_every) * \
                shape.global_batch * shape.seq_len * cfg.n_kv_heads * \
                cfg.head_dim * 2 * 2
        else:
            state = cfg.n_layers * shape.global_batch * shape.seq_len * \
                cfg.n_kv_heads * cfg.head_dim * 2 * 2
        ideal_s = max(ideal_s, (w_bytes + state) / n_dev / spec.hbm_bw)
    cell.roofline_fraction = (ideal_s / cell.bound_time_s
                              if cell.bound_time_s else 0.0)
    cell.note = src
    cell.ok = True
    return cell


def analyze_all(out_dir: str | Path = "artifacts/dryrun_torch"
                ) -> list[CellRoofline]:
    from ..configs import ASSIGNED_ARCHS
    cells = []
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            cells.append(analyze_cell(arch, shape, out_dir=out_dir))
    return cells


def markdown_table(cells: list[CellRoofline]) -> str:
    hdr = ("| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
           "dominant | useful ratio | roofline frac | note |\n"
           "|---|---|---|---|---|---|---|---|---|")
    return "\n".join([hdr] + [c.row() for c in cells])


def main():
    cells = analyze_all()
    print(markdown_table(cells))
    Path("artifacts").mkdir(exist_ok=True)
    Path("artifacts/roofline_torch.json").write_text(json.dumps(
        [vars(c) for c in cells], indent=1))


if __name__ == "__main__":
    main()
