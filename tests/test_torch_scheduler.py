"""The port's `CrossTenantBatchScheduler` against the reference's, in
lockstep on the CPU: the scheduler cases of tests/test_tenancy.py
(`test_mixed_batch_scheduler_equivalence`,
`test_scheduler_pads_partial_batches_with_no_tenant` and the scheduler half
of `test_sentinel_tenant_ids_cannot_resurrect_tombstones`).

Both facades get the same tickets and queries; tickets, launches, results
(indices and scores bit for bit) and byte ledgers must agree, and each
result must equal the port's own sequential masked retrieval and, for the
top-1, a standalone per-tenant database.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.tenancy import CrossTenantBatchScheduler as JScheduler
from repro_torch.core import BitPlanarDB, QuantizedDB
from repro_torch.core.retrieval import (two_stage_retrieve,
                                        two_stage_retrieve_masked)
from repro_torch.tenancy import CrossTenantBatchScheduler
from test_torch_tenancy import _eq, build_pair, qcodes


def _schedulers(pair, max_batch):
    return (JScheduler(pair.j, max_batch=max_batch),
            CrossTenantBatchScheduler(pair.t, max_batch=max_batch))


def _submit(jsched, sched, tenant, q):
    rid = sched.submit(tenant, q)
    assert rid == jsched.submit(tenant, q)
    return rid


def _flush(jsched, sched):
    out, jout = sched.flush(), jsched.flush()
    assert out.keys() == jout.keys()
    for rid in out:
        _eq(out[rid].indices, jout[rid].indices, "indices")
        _eq(out[rid].scores, jout[rid].scores, "scores")
    assert (sched.pending(), sched.launches) == (jsched.pending(),
                                                 jsched.launches)
    assert sched.stage1_bytes_streamed == jsched.stage1_bytes_streamed
    assert sched.stage1_bytes_vmapped == jsched.stage1_bytes_vmapped
    assert sched.stage_bytes == jsched.stage_bytes
    return out


def test_mixed_batch_scheduler_equivalence():
    """One flush over a mixed batch == per-request sequential masked
    retrieval == per-tenant standalone retrieval (slot-shifted)."""
    pair, data = build_pair(num_tenants=4, docs_per_tenant=40)
    jsched, sched = _schedulers(pair, 8)
    requests = []
    for t in (2, 0, 3, 1, 2, 0):
        j = len(requests) % 4
        q = qcodes(data[t][1][j])
        requests.append((_submit(jsched, sched, t, q), t, j, q))
    out = _flush(jsched, sched)
    assert sched.pending() == 0 and sched.launches == 1
    idx = pair.t
    db = idx.arena.db()
    for rid, t, j, q in requests:
        got = out[rid]
        seq = two_stage_retrieve_masked(torch.tensor(q), db,
                                        idx.arena.owner, t, idx.cfg,
                                        device="cpu")
        assert torch.equal(got.indices, seq.indices)
        assert torch.equal(got.scores, seq.scores)
        docs, _, gold, slots = data[t]
        codes = idx.arena.quantize(docs)
        bp = BitPlanarDB.from_quantized(QuantizedDB(
            values=codes, scale=idx.arena.scale,
            norms_sq=(codes.to(torch.int32) ** 2).sum(-1,
                                                      dtype=torch.int32)))
        solo = two_stage_retrieve(torch.tensor(q), bp, idx.cfg,
                                  device="cpu")
        assert int(got.indices[0]) - int(slots[0]) == int(solo.indices[0])


def test_scheduler_pads_partial_batches_with_no_tenant():
    pair, data = build_pair(num_tenants=2)
    jsched, sched = _schedulers(pair, 8)
    rid = _submit(jsched, sched, 0, qcodes(data[0][1][0]))
    out = _flush(jsched, sched)
    assert int(out[rid].indices[0]) == int(data[0][3][data[0][2][0]])
    assert pair.t.last_plan.batch == 1


def test_scheduler_refuses_the_sentinel_tenant():
    pair, data = build_pair()
    pair.delete(0, data[0][3][:4])
    q = qcodes(data[0][1][0])
    jsched, sched = _schedulers(pair, 16)
    for s in (jsched, sched):
        with pytest.raises(ValueError):
            s.submit(-1, q)
    assert sched.pending() == jsched.pending() == 0
