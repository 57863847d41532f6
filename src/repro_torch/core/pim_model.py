"""DB-PIM architecture performance model (Sec. V / VI).

The port's own copy of ``repro.core.pim_model`` (numpy, host side: it
reads sparsity metadata, never tensors on the card), so the port imports
nothing of the JAX package. Its numbers are the reference's, to the bit.

A loop-nest-faithful cycle / energy / utilization model of

  * the dense digital SRAM-PIM baseline (ADC-less macro of [20]: weights
    stored bit-parallel across columns, inputs broadcast bit-serially,
    16 rows per compartment time-multiplexed over one LPU), and
  * DB-PIM (this paper): Comp-pattern-only storage, per-filter phi_th
    column allocation, sparse allocation network (value-level skip),
    IPU input zero-bit-column skip, CSD adder trees.

It follows the mapping of Fig. 9: Tm = 4 macros/core (same weights,
different output pixels), Tn = 8*alpha filters across 8 cores,
Tk = Tk1 x Tk2 = 16 x 16 reduction elements per tile; Tk2 sequential,
everything else spatial. Cycle counts are derived from tile counts — the
same structure as the paper's cycle-accurate simulator, abstracted above
individual control cycles.

The model consumes REAL sparsity metadata (masks, per-filter phi_th, input
bit-column statistics) from the FTA export, so speedups move with the
actual pruning outcome, not with a hardcoded ratio.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np



# --------------------------------------------------------------------------
# Hardware description
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class PIMConfig:
    n_cores: int = 8
    macros_per_core: int = 4          # Tm
    compartments: int = 16            # Tk1
    rows_per_compartment: int = 16    # Tk2 (sequential; share one LPU)
    columns: int = 16                 # DBMUs per compartment = macro columns
    weight_bits: int = 8
    input_bits: int = 8
    input_group: int = 16             # IPU zero-column detection group size
    freq_mhz: float = 500.0

    # SIMD core (dw-conv, elementwise mul, pooling, ReLU, ResAdd, quant):
    # present in BOTH the dense baseline and DB-PIM (Sec. V-A / VII).
    simd_macs_per_cycle: int = 64

    # Energy constants (pJ), loosely calibrated against the 28 nm macro of
    # [20] (27.38 TOPS/W INT8) and typical SRAM buffer access costs. Ratios,
    # not absolutes, are the reproduction target.
    e_cell_cycle: float = 0.0020      # per active SRAM cell x cycle (AND+tree)
    e_lpu_extra: float = 0.0004      # DBMU dual-AND + CSD-tree overhead/cell
    e_input_buf_bit: float = 0.0100   # input buffer read, per bit broadcast
    e_output_acc: float = 0.1500      # accumulator/output RF update per psum
    e_weight_load_cell: float = 0.0100  # per cell written at tile switch
    e_meta_rf_bit: float = 0.0008     # sign/index RF read per cell x cycle
    e_ipu_group: float = 0.0200       # IPU detect per input group x bit
    e_switch_input: float = 0.0100    # sparse allocation network per input
    e_simd_mac: float = 0.5000        # SIMD core, per INT8 MAC-equivalent

    @property
    def tk(self) -> int:
        return self.compartments * self.rows_per_compartment   # 256

    @property
    def dense_filters_per_macro(self) -> int:
        return self.columns // self.weight_bits                 # 2

    @property
    def alpha(self) -> int:
        # pruning block granularity = columns / max phi_th (Sec. IV-C): 8
        return self.columns // 2


DEFAULT_PIM = PIMConfig()


# --------------------------------------------------------------------------
# Workload description
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerGEMM:
    """One layer after im2col: O[M,N] = I[M,K] @ W[K,N]."""
    name: str
    M: int
    K: int
    N: int
    kind: str = "std"   # std | pw | dw | fc | mul | etc


@dataclass
class LayerSparsity:
    """Real metadata for one layer (from an FTA export)."""
    # Fraction of 1 x alpha blocks pruned (value-level).
    value_sparsity: float = 0.0
    # Per-filter phi_th histogram [n_th0, n_th1, n_th2] over N filters.
    phi_hist: Sequence[int] = field(default_factory=lambda: [0, 0, 0])
    # Per alpha-group max-phi_th histogram [g0, g1, g2]: the mapper packs
    # 2 groups/macro when every filter in the group has phi_th <= 1, else 1
    # (paper: "16 filters with threshold 1, 8 with threshold 2").
    group_phimax_hist: Sequence[int] = field(default_factory=lambda: [0, 0, 0])
    # Sum of phi_th over all filters (true stored column count).
    col_loads: float = 0.0
    # Macro loads after the offline mapper bin-packs groups: a group needs
    # sum(phi) columns; a macro holds 16 columns and at most 2 groups (the
    # per-core switch interleaves two row streams — paper: "16 filters at
    # threshold 1" = two alpha-groups in one macro).
    macro_loads: Optional[float] = None
    # Mean fraction of input bit-columns that are all-zero per group.
    input_zero_col_frac: float = 0.0
    # Mean / lockstep-max surviving K rows per filter group.
    k_eff: Optional[float] = None
    k_eff_max8: Optional[float] = None


def sparsity_from_export(q: np.ndarray, mask: np.ndarray,
                         phi_th: np.ndarray,
                         input_zero_col_frac: float = 0.0) -> LayerSparsity:
    """Build LayerSparsity from a qat.FTAExport's arrays. q: (K, N)."""
    mask = np.asarray(mask)
    phi_th = np.asarray(phi_th)
    v_s = 1.0 - mask.mean()
    hist = np.bincount(np.clip(phi_th, 0, 2), minlength=3).tolist()
    K, N = mask.shape
    alpha = DEFAULT_PIM.alpha
    n_groups = max(N // alpha, 1)
    phimax = phi_th.reshape(n_groups, -1).max(axis=1)
    ghist = np.bincount(np.clip(phimax, 0, 2), minlength=3).tolist()
    # surviving rows per alpha-group (a row survives if any weight kept)
    groups = mask.reshape(K, n_groups, -1).any(axis=2)        # (K, G)
    per_group = groups.sum(axis=0)                            # rows per group
    k_eff = float(per_group.mean())
    # Lockstep: the 8 cores run a tile for max(rows) over its 8 resident
    # groups. The offline compiler bin-packs groups by occupancy (sorted
    # assignment), so the max is taken over similar groups.
    pad = (-len(per_group)) % 8
    pg = np.sort(np.concatenate([per_group,
                                 np.zeros(pad, dtype=per_group.dtype)]))
    tile_max = pg.reshape(-1, 8).max(axis=1)
    live = tile_max > 0
    k_eff_max8 = float(tile_max[live].mean()) if live.any() else 0.0
    # Offline mapper: first-fit-decreasing bin-pack of groups into macros
    # (16 columns, <= 2 groups each). Well approximated by the two lower
    # bounds' max.
    cols_per_group = np.minimum(phi_th, 2).reshape(n_groups, -1).sum(axis=1)
    live_groups = int((cols_per_group > 0).sum())
    total_cols = float(cols_per_group.sum())
    macro_loads = max(np.ceil(total_cols / DEFAULT_PIM.columns),
                      np.ceil(live_groups / 2.0), 0.0)
    return LayerSparsity(value_sparsity=float(v_s), phi_hist=hist,
                         group_phimax_hist=ghist,
                         col_loads=total_cols,
                         macro_loads=float(macro_loads),
                         input_zero_col_frac=float(input_zero_col_frac),
                         k_eff=k_eff, k_eff_max8=k_eff_max8)


def input_zero_col_fraction(acts_int8: np.ndarray, group: int = 16,
                            bits: int = 8) -> float:
    """Fraction of all-zero bit columns over groups of `group` consecutive
    int8 activations (Fig. 3b statistic). Sign-magnitude view: a bit column
    is skippable when that bit is 0 in every value of the group."""
    a = np.abs(np.asarray(acts_int8).astype(np.int32)).ravel()
    n = (a.size // group) * group
    if n == 0:
        return 0.0
    a = a[:n].reshape(-1, group)
    cols_zero = 0
    for b in range(bits):
        colbit = (a >> b) & 1
        cols_zero += (colbit.max(axis=1) == 0).sum()
    return float(cols_zero / (a.shape[0] * bits))


# --------------------------------------------------------------------------
# Cycle / energy / utilization model
# --------------------------------------------------------------------------

@dataclass
class LayerReport:
    name: str
    cycles: float
    energy_pj: float
    eff_cells: float      # cells doing useful (non-zero-operand) work
    total_cells: float    # cells activated
    macs: float

    @property
    def u_act(self) -> float:
        return self.eff_cells / max(self.total_cells, 1.0)


def _ceil(a: float, b: float) -> float:
    return float(int(np.ceil(a / b)))


def _active_cells_per_rowcycle(cfg: PIMConfig) -> float:
    """Digital PIM mandates full-array activation: per row-cycle every
    compartment drives one cell in each of its columns, in every macro."""
    return (cfg.compartments * cfg.columns
            * cfg.macros_per_core * cfg.n_cores)


def dense_baseline_layer(layer: LayerGEMM, cfg: PIMConfig = DEFAULT_PIM,
                         nonzero_bit_frac: float = 0.45) -> LayerReport:
    """Dense digital-PIM baseline ([20]-style): weights bit-parallel (8
    columns/filter -> 2 filters/macro, 16 filters across 8 cores), all K
    rows occupied, all 8 input bits broadcast bit-serially.

    nonzero_bit_frac: fraction of stored weight bits that are non-zero —
    only used for the *utilization* metric (dense compute wastes the rest).
    """
    n_par = cfg.n_cores * cfg.dense_filters_per_macro          # 16 filters
    row_cycles = _ceil(layer.K, cfg.compartments)
    n_tiles = _ceil(layer.N, n_par)
    m_tiles = _ceil(layer.M, cfg.macros_per_core)
    cycles = m_tiles * n_tiles * row_cycles * cfg.input_bits

    activated = cycles * _active_cells_per_rowcycle(cfg)
    fill_k = layer.K / (row_cycles * cfg.compartments)
    fill_n = layer.N / (n_tiles * n_par)
    fill_m = layer.M / (m_tiles * cfg.macros_per_core)
    eff = activated * nonzero_bit_frac * fill_k * fill_n * min(fill_m, 1.0)

    cells_per_macro = cfg.compartments * cfg.rows_per_compartment * cfg.columns
    n_weight_loads = _ceil(layer.K, cfg.tk) * n_tiles
    e = (activated * cfg.e_cell_cycle
         + layer.M * layer.K * cfg.input_bits * cfg.e_input_buf_bit
         + n_weight_loads * cells_per_macro * cfg.n_cores * cfg.e_weight_load_cell
         + m_tiles * n_tiles * layer.N * cfg.macros_per_core * cfg.e_output_acc)
    return LayerReport(layer.name, cycles, e, eff, activated,
                       macs=float(layer.M) * layer.K * layer.N)


def dbpim_layer(layer: LayerGEMM, sp: LayerSparsity,
                cfg: PIMConfig = DEFAULT_PIM,
                use_value: bool = True, use_weight_bit: bool = True,
                use_input_bit: bool = True,
                value_skip_efficiency: float = 1.00) -> LayerReport:
    """DB-PIM cycles/energy for one layer given its real sparsity metadata.

    Ablation switches reproduce the paper's breakdown (Fig. 12):
      use_value      -> sparse allocation network (skip pruned blocks)
      use_weight_bit -> FTA Comp-pattern packing (16/phi filters per macro)
      use_input_bit  -> IPU zero-bit-column skip

    value_skip_efficiency: fraction of pruned-row cycles actually recovered.
    Row skipping is bounded by the sparse allocation network's sequential
    input extraction (one shared switch per core, pipelined over Tm macros,
    scanning the ORIGINAL index range) and by cross-core lockstep (a tile
    runs for the max row count over its 8 resident groups). Calibrated to
    the paper's Fig. 11 (8.10x/5.50x => 60% value sparsity recovers ~47%
    extra cycles, i.e. ~0.55 efficiency on skipped rows).
    """
    N = layer.N
    ghist = np.asarray(sp.group_phimax_hist, dtype=np.float64)
    if ghist.sum() == 0:                                   # dense fallback
        ghist = np.array([0.0, 0.0, max(N / cfg.alpha, 1.0)])

    # ---- N dimension: macro loads from the mapper's group bin-packing
    if use_weight_bit:
        if sp.macro_loads is not None:
            macro_loads = sp.macro_loads
        else:  # fall back to phi_max packing
            macro_loads = ghist[2] + _ceil(ghist[1], 2)
        n_tiles = max(_ceil(macro_loads, cfg.n_cores), 1.0)
    else:
        n_tiles = _ceil(N, cfg.n_cores * cfg.dense_filters_per_macro)

    # ---- K dimension: value-level row skip (bounded efficiency + lockstep)
    if use_value:
        k_base = sp.k_eff_max8 if sp.k_eff_max8 is not None else \
            layer.K * (1 - sp.value_sparsity)
        k_sched = layer.K - value_skip_efficiency * (layer.K - k_base)
    else:
        k_sched = float(layer.K)
    row_cycles = max(_ceil(k_sched, cfg.compartments), 1.0)

    # ---- input bit dimension: IPU skips all-zero bit columns
    eff_bits = cfg.input_bits * (1 - sp.input_zero_col_frac) if use_input_bit \
        else float(cfg.input_bits)
    eff_bits = max(eff_bits, 1.0)

    m_tiles = _ceil(layer.M, cfg.macros_per_core)
    cycles = m_tiles * n_tiles * row_cycles * eff_bits

    # ---- utilization: every STORED cell holds a Comp pattern and computes
    # a useful AND; waste = column padding (phi_1 filters inside phi_max=2
    # groups + ragged tiles), row padding, idle M slots. Input-extraction
    # stall cycles (the value_skip_efficiency loss) do NOT activate cells.
    k_eff_true = sp.k_eff if (use_value and sp.k_eff is not None) else float(layer.K)
    active_row_cycles = max(_ceil(k_eff_true, cfg.compartments), 1.0)
    activated = (m_tiles * n_tiles * active_row_cycles * eff_bits
                 * _active_cells_per_rowcycle(cfg))
    col_alloc = n_tiles * cfg.n_cores * cfg.columns
    if use_weight_bit:
        col_used = sp.col_loads if sp.col_loads else N * 2.0
        fill_n = min(col_used / max(col_alloc, 1.0), 1.0)
        bit_eff = 1.0          # stored cells are all non-zero Comp patterns
    else:
        fill_n = min(N * cfg.weight_bits / max(col_alloc, 1.0), 1.0)
        bit_eff = 0.45         # zero bits still stored, as in the baseline
    fill_k = min(k_eff_true / (active_row_cycles * cfg.compartments), 1.0)
    fill_m = min(layer.M / (m_tiles * cfg.macros_per_core), 1.0)
    eff = activated * bit_eff * fill_n * fill_k * fill_m

    cells_per_macro = cfg.compartments * cfg.rows_per_compartment * cfg.columns
    n_weight_loads = _ceil(k_eff_true, cfg.tk) * n_tiles
    n_inputs_routed = layer.M * k_eff_true
    e = (activated * (cfg.e_cell_cycle + cfg.e_lpu_extra + cfg.e_meta_rf_bit)
         + n_inputs_routed * eff_bits * cfg.e_input_buf_bit
         + n_inputs_routed * cfg.e_switch_input
         + layer.M * _ceil(k_eff_true, cfg.input_group) * cfg.input_bits * cfg.e_ipu_group
         + n_weight_loads * cells_per_macro * cfg.n_cores * cfg.e_weight_load_cell
         + m_tiles * n_tiles * N * cfg.macros_per_core * cfg.e_output_acc)
    return LayerReport(layer.name, cycles, e, eff, activated,
                       macs=float(layer.M) * layer.K * layer.N)


def simd_layer(layer: LayerGEMM, cfg: PIMConfig = DEFAULT_PIM) -> LayerReport:
    """Non-matmul-friendly ops (dw-conv, mul, pooling, ReLU, ResAdd) run on
    the SIMD vector core in both systems — the paper's Fig. 13 bottleneck."""
    macs = float(layer.M) * layer.K * layer.N if layer.kind == "dw" \
        else float(layer.M) * max(layer.K, 1) * max(layer.N, 1)
    if layer.kind == "dw":
        # dw-conv: K = kh*kw, N = channels; each output needs K MACs.
        macs = float(layer.M) * layer.K * layer.N
    cycles = macs / cfg.simd_macs_per_cycle
    e = macs * cfg.e_simd_mac
    return LayerReport(layer.name, cycles, e, eff_cells=0.0, total_cells=0.0,
                       macs=macs)


# --------------------------------------------------------------------------
# Model-level aggregation
# --------------------------------------------------------------------------

@dataclass
class ModelReport:
    layers: List[LayerReport]

    @property
    def cycles(self) -> float:
        return sum(l.cycles for l in self.layers)

    @property
    def energy_pj(self) -> float:
        return sum(l.energy_pj for l in self.layers)

    @property
    def u_act(self) -> float:
        eff = sum(l.eff_cells for l in self.layers)
        tot = sum(l.total_cells for l in self.layers)
        return eff / max(tot, 1.0)

    def time_ms(self, cfg: PIMConfig = DEFAULT_PIM) -> float:
        return self.cycles / (cfg.freq_mhz * 1e3)


def evaluate_model(layers: Sequence[LayerGEMM],
                   sparsities: Dict[str, LayerSparsity],
                   cfg: PIMConfig = DEFAULT_PIM,
                   use_value=True, use_weight_bit=True, use_input_bit=True,
                   accel_kinds=("std", "pw", "fc")) -> ModelReport:
    """DB-PIM report over accelerated layers (dw-conv etc. handled by the
    SIMD core — modeled as dense)."""
    reps = []
    for layer in layers:
        if layer.kind in accel_kinds:
            sp = sparsities.get(layer.name, LayerSparsity())
            reps.append(dbpim_layer(layer, sp, cfg, use_value,
                                    use_weight_bit, use_input_bit))
        else:
            reps.append(simd_layer(layer, cfg))
    return ModelReport(reps)


def evaluate_dense_baseline(layers: Sequence[LayerGEMM],
                            cfg: PIMConfig = DEFAULT_PIM,
                            accel_kinds=("std", "pw", "fc")) -> ModelReport:
    """Dense digital-PIM baseline: matmul layers on the PIM cores, the rest
    on the same SIMD core (identical in both systems)."""
    return ModelReport([dense_baseline_layer(l, cfg) if l.kind in accel_kinds
                        else simd_layer(l, cfg) for l in layers])
