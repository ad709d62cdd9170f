"""Energy / memory-access / compute cost model (the paper's Python simulator).

A verbatim copy of `repro.core.energy` (pure Python, constants included),
kept here so the port imports nothing of the JAX package. No H100 constant
set exists: the two sets below are the paper's and the reference's.

Reproduces:
  * Table II  — per-module energy for a 1 MB INT8 database query,
  * Fig. 4    — memory-access & computation reduction vs corpus size,
  * Fig. 5(b) — energy per query for INT8 / INT4 / hierarchical formats,
  * Table III — energy/query comparison on a SciFact-sized corpus.

Accounting model (documented; the paper gives pJ/bit constants in Table II
and we derive traffic/ops from the architecture):

  DRAM bits   = bits streamed off-chip.  Stage 1 reads the 4 MSB bit-planes
                of every document (bit-planar storage makes this exact);
                stage 2 re-reads the full 8 bits of the C candidates.
  SRAM bits   = 2 x DRAM bits (streaming buffers are written then read once;
                query-stationary dataflow means the query contributes only
                D*8 bits once — negligible and included).
  PE bits     = MACs x (bits_a + bits_b + ACC_BITS): every MAC consumes two
                operands and updates a 32-bit accumulator.
  SimCalc bits= MACs x ACC_BITS  (partial-sum fusion across the 4 PEs,
                norm handling, final similarity).
  Rerank bits = comparisons x 2 x ACC_BITS, with the paper's streaming dense
                comparator doing N comparisons against the running top-C in
                stage 1 plus C*C dense comparisons in stage 2.

A second constant set (TPU_V5E) reuses the same accounting at pod scale so
the benefit of hierarchical retrieval can be stated for the TPU target
(HBM pJ/bit derived from public v5e HBM power/bandwidth estimates).
"""
from __future__ import annotations

import dataclasses
import functools
import math

ACC_BITS = 32
NORM_BITS = 32  # stored per-doc squared-norm sidecar


@dataclasses.dataclass(frozen=True)
class EnergyConstants:
    """pJ per bit moved/processed, per module."""
    name: str
    dram: float
    sram: float
    pe: float
    simcalc: float
    rerank: float


# Paper Table II (TSMC 28 nm; DRAM constants from Horowitz / Sze et al.)
PAPER_28NM = EnergyConstants(name="paper-28nm", dram=40.0, sram=0.2,
                             pe=0.0078, simcalc=0.0003, rerank=0.0001)

# TPU v5e-equivalent accounting: HBM2e ~= 819 GB/s; public estimates put HBM
# power at ~3-4 W per chip => ~0.5 pJ/bit effective; VMEM ~0.05 pJ/bit; MXU
# MAC energy folded into 'pe'. These are order-of-magnitude constants used
# ONLY for relative comparisons (hierarchical vs INT8) at pod scale.
TPU_V5E = EnergyConstants(name="tpu-v5e", dram=0.5, sram=0.05,
                          pe=0.002, simcalc=0.0003, rerank=0.0001)


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """Per-module energy (pJ) + traffic/compute tallies for one query."""
    dram_bits: float
    sram_bits: float
    pe_bits: float
    simcalc_bits: float
    rerank_bits: float
    macs: float
    dram_pj: float
    sram_pj: float
    pe_pj: float
    simcalc_pj: float
    rerank_pj: float

    @property
    def total_pj(self) -> float:
        return (self.dram_pj + self.sram_pj + self.pe_pj
                + self.simcalc_pj + self.rerank_pj)

    @property
    def total_uj(self) -> float:
        return self.total_pj * 1e-6

    def proportions(self) -> dict[str, float]:
        t = self.total_pj
        return {"DRAM": self.dram_pj / t, "SRAM": self.sram_pj / t,
                "PE": self.pe_pj / t, "SimCalc": self.simcalc_pj / t,
                "Rerank": self.rerank_pj / t}


def _cost(n_docs: int, dim: int, *, doc_bits_read, mac_terms, compares,
          consts: EnergyConstants, include_norms: bool,
          cached_bits: float = 0.0) -> CostBreakdown:
    """cached_bits: doc bits served from ON-CHIP memory instead of DRAM
    (the serving runtime's hot-cluster cache). A streamed bit is written
    into SRAM then read back (2x); a cached bit is already resident and
    read once — so hits are charged 1x SRAM and zero DRAM."""
    dram_bits = doc_bits_read + (n_docs * NORM_BITS if include_norms else 0)
    sram_bits = 2 * dram_bits + cached_bits + dim * 8  # + one query load
    macs = sum(m for m, _, _ in mac_terms)
    pe_bits = sum(m * (ba + bb + ACC_BITS) for m, ba, bb in mac_terms)
    simcalc_bits = macs * ACC_BITS
    rerank_bits = compares * 2 * ACC_BITS
    return CostBreakdown(
        dram_bits=dram_bits, sram_bits=sram_bits, pe_bits=pe_bits,
        simcalc_bits=simcalc_bits, rerank_bits=rerank_bits, macs=macs,
        dram_pj=dram_bits * consts.dram, sram_pj=sram_bits * consts.sram,
        pe_pj=pe_bits * consts.pe, simcalc_pj=simcalc_bits * consts.simcalc,
        rerank_pj=rerank_bits * consts.rerank,
    )


def default_candidates(n_docs: int, max_candidates: int = 50,
                       frac: float = 0.2) -> int:
    return max(1, min(max_candidates, math.ceil(frac * n_docs)))


def cost_int8(n_docs: int, dim: int = 512, *, consts=PAPER_28NM,
              include_norms: bool = False) -> CostBreakdown:
    """Baseline: pure INT8 retrieval over the whole corpus."""
    return _cost(n_docs, dim,
                 doc_bits_read=n_docs * dim * 8,
                 mac_terms=[(n_docs * dim, 8, 8)],
                 compares=n_docs,
                 consts=consts, include_norms=include_norms)


def cost_int4(n_docs: int, dim: int = 512, *, consts=PAPER_28NM,
              include_norms: bool = False) -> CostBreakdown:
    """Baseline: pure INT4 (MSB nibble only) retrieval."""
    return _cost(n_docs, dim,
                 doc_bits_read=n_docs * dim * 4,
                 mac_terms=[(n_docs * dim, 4, 4)],
                 compares=n_docs,
                 consts=consts, include_norms=include_norms)


def cost_hierarchical(n_docs: int, dim: int = 512, *, candidates: int | None = None,
                      consts=PAPER_28NM, include_norms: bool = False) -> CostBreakdown:
    """The paper's two-stage scheme: MSB-INT4 over all docs + INT8 over C."""
    c = default_candidates(n_docs) if candidates is None else candidates
    return _cost(n_docs, dim,
                 doc_bits_read=n_docs * dim * 4 + c * dim * 8,
                 mac_terms=[(n_docs * dim, 4, 4), (c * dim, 8, 8)],
                 compares=n_docs + c * c,
                 consts=consts, include_norms=include_norms)


def cost_cascade(stages, dim: int = 512, *, batch: int = 1,
                 consts=PAPER_28NM,
                 include_norms: bool = False) -> CostBreakdown:
    """Measured-counts cost of ONE query of an N-stage retrieval cascade.

    `stages` is a launch's per-stage ledger — engine.SchedulePlan.stages,
    i.e. objects with `rows` (rows scored per lane), `bits` (operand
    width), `bytes_hbm` (plane bytes the whole LAUNCH streamed for the
    stage), optional `bytes_sram` (plane bytes the launch served from the
    serving runtime's hot-cluster cache — charged at SRAM rates, zero
    DRAM, same MACs) and `compares` — so the ledger charges what the
    schedule ACTUALLY streamed (windowed lanes their window, cluster-
    pruned lanes their probed blocks, cache hits the on-chip rate,
    shared-plane stages amortized over `batch`) instead of re-deriving
    traffic from the `default_candidates` heuristic and a full-corpus
    scan.
    """
    stages = tuple(stages)
    b = max(1, batch)
    doc_bits = sum(s.bytes_hbm * 8 for s in stages) / b
    cached_bits = sum(getattr(s, "bytes_sram", 0) * 8 for s in stages) / b
    mac_terms = [(s.rows * dim, s.bits, s.bits) for s in stages]
    compares = sum(s.compares for s in stages)
    # The norms sidecar is read once per stage-1-scored row (4-bit stages
    # rank on the approximate cosine key; the exact stage re-reads its
    # candidates' norms, already counted in its rows).
    norm_rows = sum(s.rows for s in stages if s.bits == 4)
    return _cost(norm_rows, dim, doc_bits_read=doc_bits,
                 mac_terms=mac_terms, compares=compares,
                 consts=consts, include_norms=include_norms,
                 cached_bits=cached_bits)


def cost_per_stage(stages, dim: int = 512, *, batch: int = 1,
                   consts=PAPER_28NM,
                   include_norms: bool = False) -> dict[str, CostBreakdown]:
    """Price each cascade stage of a launch SEPARATELY, keyed by its
    `plan.stages` name — no special-casing per stage kind, so a new
    stage (e.g. the 1-bit sign prescreen) is charged and exported the
    moment it appears in the ledger. Each stage is costed as a
    single-stage cascade; the per-query SRAM query-load term (dim * 8
    bits) is charged once per stage, so the stage sum exceeds the fused
    `cost_cascade` total by (len(stages) - 1) * dim * 8 * sram pJ —
    sub-permille, and the headline histogram keeps using the fused
    total."""
    return {s.name: cost_cascade((s,), dim, batch=batch, consts=consts,
                                 include_norms=include_norms)
            for s in stages}


@functools.lru_cache(maxsize=64)
def _stage_uj_coeffs(bits: int, dim: int, batch: int, consts,
                     include_norms: bool) -> tuple:
    """Per-stage price as LINEAR coefficients over the ledger fields.

    A single-stage `cost_cascade` total is linear in (bytes_hbm,
    bytes_sram, rows, compares); only these coefficients depend on
    (bits, dim, batch, consts) — all stable across a serving runtime's
    launches even when the cached path's hit/miss byte split varies
    every turn. The hot metrics path therefore pays a cache hit plus
    four multiply-adds per stage instead of pricing a fresh
    CostBreakdown, which is what keeps the per-stage energy export
    inside the observability overhead budget."""
    b = max(1, batch)
    per_hbm_byte = 8.0 / b * (consts.dram + 2.0 * consts.sram)
    per_sram_byte = 8.0 / b * consts.sram
    per_row = dim * ((2 * bits + ACC_BITS) * consts.pe
                     + ACC_BITS * consts.simcalc)
    if include_norms and bits == 4:
        per_row += NORM_BITS * (consts.dram + 2.0 * consts.sram)
    per_compare = 2.0 * ACC_BITS * consts.rerank
    query_load = dim * 8.0 * consts.sram
    return per_hbm_byte, per_sram_byte, per_row, per_compare, query_load


def stage_cost_uj(stage, dim: int = 512, *, batch: int = 1,
                  consts=PAPER_28NM, include_norms: bool = False) -> float:
    """Fast path for `cost_per_stage(...)[name].total_uj`: same price
    (to float round-off), no CostBreakdown construction — pinned against
    the exact single-stage cascade by test_energy."""
    a_hbm, a_sram, a_row, a_cmp, c0 = _stage_uj_coeffs(
        stage.bits, dim, max(1, batch), consts, include_norms)
    return (stage.bytes_hbm * a_hbm
            + getattr(stage, "bytes_sram", 0) * a_sram
            + stage.rows * a_row + stage.compares * a_cmp + c0) * 1e-6


def observe_cost(registry, cost: CostBreakdown, *, queries: int = 1,
                 stages=None, dim: int = 512, batch: int = 1,
                 consts=PAPER_28NM) -> None:
    """Record a launch's priced PER-QUERY cost into a metrics registry.

    Feeds the serving stack's energy distributions: `energy_uj_per_query`
    is the headline µJ/query histogram (p50/p99 over the ACTUAL served
    trace, not the last launch), plus a per-module breakdown so exporter
    output mirrors the paper's Table II columns. When the launch's
    `plan.stages` ledger is passed via `stages`, a per-STAGE breakdown
    (`energy_uj_per_query_stage`, labelled by stage name) is exported
    too — driven entirely by the ledger, so every stage the schedule
    runs (prune / prescreen / approx / exact) is split out without
    enumeration here. `queries` weights the sample by the launch's real
    batch occupancy so trace-level medians are per QUERY, not per
    launch. Duck-typed against repro.obs.MetricsRegistry and a no-op
    when disabled."""
    if not getattr(registry, "enabled", False):
        return
    registry.histogram("energy_uj_per_query").observe(cost.total_uj,
                                                      queries)
    for module, pj in (("dram", cost.dram_pj), ("sram", cost.sram_pj),
                       ("pe", cost.pe_pj), ("simcalc", cost.simcalc_pj),
                       ("rerank", cost.rerank_pj)):
        registry.histogram("energy_uj_per_query_module",
                           module=module).observe(pj * 1e-6, queries)
    if stages:
        for s in stages:
            registry.histogram("energy_uj_per_query_stage",
                               stage=s.name).observe(
                stage_cost_uj(s, dim, batch=batch, consts=consts), queries)


def observe_decode_cost(registry, cost: CostBreakdown, *,
                        tokens: int = 1) -> None:
    """Record a decode launch's priced PER-TOKEN cost.

    The decode-side sibling of `observe_cost`: the KV cascade's
    `kv_plan` ledger priced through the SAME `cost_cascade` model lands
    in `energy_uj_per_token`, so a serving trace exposes whole-turn
    µJ/token next to retrieval's µJ/query from one registry. `cost` must
    already be per token (one decode step); `tokens` weights the sample
    by the number of steps the launch covered."""
    if not getattr(registry, "enabled", False):
        return
    registry.histogram("energy_uj_per_token").observe(cost.total_uj,
                                                      tokens)
    for module, pj in (("dram", cost.dram_pj), ("sram", cost.sram_pj),
                       ("pe", cost.pe_pj), ("simcalc", cost.simcalc_pj),
                       ("rerank", cost.rerank_pj)):
        registry.histogram("energy_uj_per_token_module",
                           module=module).observe(pj * 1e-6, tokens)

# ---------------------------------------------------------------------------
# Paper-figure helpers
# ---------------------------------------------------------------------------

def memory_reduction(n_docs: int, dim: int = 512,
                     candidates: int | None = None) -> float:
    """Fig. 4 memory-access reduction of hierarchical vs pure INT8."""
    base = cost_int8(n_docs, dim).dram_bits
    ours = cost_hierarchical(n_docs, dim, candidates=candidates).dram_bits
    return 1.0 - ours / base


def compute_reduction(n_docs: int, dim: int = 512,
                      candidates: int | None = None) -> float:
    """Fig. 4 computation reduction (nibble-MAC-equivalents: an 8x8 MAC
    decomposes into 4 nibble MACs on the paper's 4-bit PEs)."""
    def nibble_macs(cb: CostBreakdown, terms):
        return sum(m * (ba // 4) * (bb // 4) for m, ba, bb in terms)
    c = default_candidates(n_docs) if candidates is None else candidates
    base = nibble_macs(None, [(n_docs * dim, 8, 8)])
    ours = nibble_macs(None, [(n_docs * dim, 4, 4), (c * dim, 8, 8)])
    return 1.0 - ours / base


def db_bytes(n_docs: int, dim: int = 512) -> int:
    return n_docs * dim  # INT8: 1 byte per dim


def docs_for_db_mb(mb: float, dim: int = 512) -> int:
    return int(mb * 1024 * 1024 // dim)
