"""Roofline analysis over the dry run's records.

Port of ``repro.launch.roofline``, with the H100's figures. Per (arch x
shape x mesh) cell, the roofline terms for a mesh of H100 SXM5 80GB
cards, each figure from the card's datasheet at its 700 W power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` reads
"NVIDIA H100 80GB HBM3, 700.00 W" there):

  compute term    = FLOPs / (cards x 989e12 FLOP/s)   dense bf16, 700 W
  memory term     = bytes / (cards x 3.35e12 B/s)      HBM3, 700 W
  collective term = per-card collective bytes / 450e9 B/s
                                                       NVLink 4, one
                                                       direction, 700 W

FLOPs and bytes come from the dry run's ``jaxpr_cost`` (the port's
``runtime.op_cost`` walk of the step). The port has no SPMD partitioner
and its one-card program issues no collective, so its records carry
``collectives: null``: such a cell gets no collective term, its
``reason`` says so, and its bottleneck is compute or memory.
MODEL_FLOPS reference: 6*N*D for training (N = active params, D =
tokens), 2*N*D for prefill/decode forward.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

PEAK_FLOPS = 989e12          # dense bf16 FLOP/s a card (H100 SXM5, 700 W)
HBM_BW = 3.35e12             # HBM3 B/s a card (H100 SXM5, 700 W)
ICI_BW = 450e9               # NVLink 4 B/s a card, one direction (700 W)

NO_COLLECTIVE_TERM = "no collective term: "

SHAPE_TOKENS = {
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,       # one token per sequence
    "long_500k": 1,
}


@dataclass
class RooflineCell:
    arch: str
    shape: str
    mesh: str
    chips: int
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    model_flops: float = 0.0
    hlo_flops: float = 0.0
    useful_ratio: float = 0.0
    pim_frac: float = 0.0        # share of bytes moved by the DB-PIM
                                 # kernels (joint/value/bit paths)
    bottleneck: str = ""
    roofline_fraction: float = 0.0
    temp_gb: float = 0.0
    args_gb: float = 0.0
    reason: str = ""

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def model_flops(rec: dict) -> float:
    n = rec.get("active_params", rec.get("params", 0))
    tokens = SHAPE_TOKENS[rec["shape"]]
    if rec["shape"] == "train_4k":
        return 6.0 * n * tokens
    return 2.0 * n * tokens


def analyze_record(rec: dict) -> RooflineCell:
    chips = 1
    for v in rec.get("mesh_shape", {}).values():
        chips *= v
    cell = RooflineCell(arch=rec["arch"], shape=rec["shape"],
                        mesh=rec["mesh"], chips=chips,
                        status=rec["status"],
                        reason=rec.get("reason", ""))
    if rec["status"] != "ok":
        return cell
    jc = rec.get("jaxpr_cost", {})
    cell.hlo_flops = float(jc.get("dot_flops", 0.0))
    total_flops = float(jc.get("flops", cell.hlo_flops))
    bytes_ = float(jc.get("bytes", 0.0)) + float(jc.get("arg_bytes", 0.0))
    coll = rec.get("collectives", {})

    cell.pim_frac = (float(jc.get("pallas_bytes", 0.0)) / bytes_
                     if bytes_ else 0.0)
    cell.compute_s = total_flops / (chips * PEAK_FLOPS)
    cell.memory_s = bytes_ / (chips * HBM_BW)
    terms = {"compute": cell.compute_s, "memory": cell.memory_s}
    if coll is None:
        cell.reason = NO_COLLECTIVE_TERM + rec.get(
            "collectives_reason", "the record has no collectives")
    else:
        cell.collective_s = float(coll.get("total", 0.0)) / ICI_BW
        terms["collective"] = cell.collective_s
    cell.model_flops = model_flops(rec)
    cell.useful_ratio = (cell.model_flops / cell.hlo_flops
                         if cell.hlo_flops else 0.0)
    cell.bottleneck = max(terms, key=terms.get)
    # roofline fraction: useful-model-FLOPs rate achievable at the
    # bottleneck-imposed step time vs the cards' peak.
    if cell.step_s > 0:
        cell.roofline_fraction = (cell.model_flops / cell.step_s
                                  / (chips * PEAK_FLOPS))
    mem = rec.get("memory_analysis", {})
    cell.temp_gb = mem.get("temp_size_in_bytes", 0) / 1e9
    cell.args_gb = mem.get("argument_size_in_bytes", 0) / 1e9
    return cell


def load_cells(dryrun_dir: str,
               include_variants: bool = False) -> List[RooflineCell]:
    cells = []
    for path in sorted(Path(dryrun_dir).glob("*.json")):
        rec = json.loads(path.read_text())
        if rec.get("variant") and not include_variants:
            continue
        cells.append(analyze_record(rec))
    return cells


def format_table(cells: List[RooflineCell], mesh: str = "single") -> str:
    hdr = (f"{'arch':<16}{'shape':<13}{'comp_ms':>9}{'mem_ms':>9}"
           f"{'coll_ms':>9}{'bound':>6}{'MF/HF':>7}{'roofline%':>10}"
           f"{'temp_GB':>9}{'pim%':>6}")
    lines = [hdr, "-" * len(hdr)]
    for c in cells:
        if c.mesh != mesh:
            continue
        if c.status != "ok":
            lines.append(f"{c.arch:<16}{c.shape:<13}{'SKIP':>9} "
                         f"({c.reason[:60]})")
            continue
        lines.append(
            f"{c.arch:<16}{c.shape:<13}{c.compute_s*1e3:>9.2f}"
            f"{c.memory_s*1e3:>9.2f}{c.collective_s*1e3:>9.2f}"
            f"{c.bottleneck[:4]:>6}{c.useful_ratio:>7.2f}"
            f"{c.roofline_fraction*100:>10.1f}{c.temp_gb:>9.1f}"
            f"{c.pim_frac*100:>6.1f}")
    return "\n".join(lines)
