"""The least time a served batch could take on one NVIDIA H100.

Published peaks of the SXM part (NVIDIA's data sheet, dense, 700 W):
3.35 TB/s of HBM and 1,979 TOP/s of INT8. A batch's least time is the
larger of the bytes its inputs need over the bandwidth and 2 x its MACs
over the INT8 rate (INT4 MACs are counted at the INT8 rate, which can
only lower the bound).

Needed bytes are what the inputs require, each byte counted once per
batch, and not what the program reads today:

  * the INT4 MSB rows (D / 2 bytes each) of the batch's distinct tenants,
    or of the whole corpus when one tenant owns it;
  * each lane's C candidates: the full INT8 row (D bytes) and its norm;
  * the queries (D bytes a lane) and the results: k ids, k scores and C
    candidate ids, 4 bytes each.

A program that reads less than the whole arena per batch (the Masked
policy reads all of it today) can so never show a share above 100 %.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def batch_bytes(tenant_rows: int, lanes: int, dim: int, k: int,
                candidates: int) -> int:
    """Bytes one batch needs: `tenant_rows` is the sum of the rows of the
    batch's distinct tenants."""
    return (tenant_rows * (dim // 2) + lanes * candidates * (dim + 4)
            + lanes * dim + lanes * (2 * k + candidates) * 4)


def batch_macs(lane_rows: int, lanes: int, dim: int, candidates: int) -> int:
    """MACs one batch needs: `lane_rows` is the sum over lanes of the rows
    each lane's tenant owns (stage 1); stage 2 rescores C rows a lane."""
    return lane_rows * dim + lanes * candidates * dim


def least_seconds(bytes_needed: int, macs: int) -> float:
    return max(bytes_needed / HBM_BYTES_PER_S, 2 * macs / INT8_OPS_PER_S)


def batch_least_seconds(lane_tenants, rows_of, dim: int, k: int,
                        candidates: int) -> float:
    """Least time of one batch whose lanes serve the tenants listed in
    `lane_tenants` (one entry a real request); `rows_of(t)` is the number
    of rows tenant t owns."""
    lanes = len(lane_tenants)
    distinct = set(lane_tenants)
    tenant_rows = sum(rows_of(t) for t in distinct)
    lane_rows = sum(rows_of(t) for t in lane_tenants)
    return least_seconds(batch_bytes(tenant_rows, lanes, dim, k, candidates),
                         batch_macs(lane_rows, lanes, dim, candidates))
