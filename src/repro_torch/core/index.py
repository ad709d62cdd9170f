"""Sharded hierarchical retrieval index.

Port of `repro.core.index`. The corpus is split row-wise over every shard
slot of a mesh (the flattened mesh axes, row-major). One retrieval runs:

  1. local stage-1 (MSB-nibble) scoring over each shard's rows: one
     batched plane scan per shard, so each shard's plane streams once per
     batch,
  2. a local top-C proposal per batch lane,
  3. the "tournament": every shard's (score, global id) proposals move to
     the lead slot's device, O(B * C * shards) values whatever the corpus
     size (the reference all-gathers them),
  4. the global top-C per lane (exact: the global top-C is contained in
     the union of the local top-Cs),
  5. stage-2 exact INT8 rescoring of each candidate on the shard that
     owns it only (one by-id rescore per shard), summed on the lead
     device (each row is owned once; the reference's psum),
  6. the final top-k per lane via the non-division comparator (cosine) or
     a plain top-k (MIPS), one call of the backend's `rerank`.

The shards run one after another in this process; their slots may share
a device. `cfg.backend` routes both scoring stages through the same
kernel wrappers or plain versions the single-host engine uses.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import current, resolve_device
from repro_torch.core import bitplanar, quantization, similarity
from repro_torch.core.engine import stage_fns
from repro_torch.core.retrieval import RetrievalConfig, RetrievalResult
from repro_torch.distributed.sharding import Mesh

INT32_MIN = -(2 ** 31)


def pad_database(db: bitplanar.BitPlanarDB, num_shards: int
                 ) -> bitplanar.BitPlanarDB:
    """Pad the row count to a multiple of num_shards with all-zero docs.

    Zero docs have norm 0, so cosine similarity 0 and MIPS score 0. A
    score of 0 is NOT a floor: it beats every real document whenever all
    true scores are negative (MIPS over anti-correlated queries), so
    `_tournament_retrieve` masks pad rows (gid >= n_global) out of both
    scoring stages explicitly instead of relying on their zero score."""
    pad = (-db.num_docs) % num_shards
    if pad == 0:
        return db

    def zpad(a):
        return torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])
    return bitplanar.BitPlanarDB(
        msb_plane=zpad(db.msb_plane), lsb_plane=zpad(db.lsb_plane),
        norms_sq=zpad(db.norms_sq), scale=db.scale)


def _place(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A row block on its slot's device: a view where it already lies
    there (slots that share a card share its plane), a copy otherwise; a
    view whose start is not 16-byte aligned is copied, as the kernels
    require."""
    t = t.to(dev)
    return t.clone() if t.data_ptr() % 16 else t


def shard_database(db: bitplanar.BitPlanarDB, mesh: Mesh
                   ) -> tuple[bitplanar.BitPlanarDB, ...]:
    """Split a (padded) database row-wise over the mesh's shard slots:
    slot i holds rows [i * n_local, (i + 1) * n_local) on its device."""
    s = mesh.size
    if db.num_docs % s:
        raise ValueError(f"{db.num_docs} rows do not split over {s} shards: "
                         "pad_database first")
    n_local = db.num_docs // s
    out = []
    for i, dev in enumerate(mesh.slots()):
        rows = slice(i * n_local, (i + 1) * n_local)
        out.append(bitplanar.BitPlanarDB(
            msb_plane=_place(db.msb_plane[rows], dev),
            lsb_plane=_place(db.lsb_plane[rows], dev),
            norms_sq=_place(db.norms_sq[rows], dev),
            scale=db.scale.to(dev)))
    return tuple(out)


def _tournament_retrieve(q: torch.Tensor,
                         shards: tuple[bitplanar.BitPlanarDB, ...], *,
                         cfg: RetrievalConfig, n_global: int
                         ) -> RetrievalResult:
    """The batch-native body: q (B, D) int8; each shard's rows on its own
    device; the tournament on the first shard's device."""
    n_local = shards[0].num_docs
    lead = shards[0].msb_plane.device
    c = min(cfg.num_candidates(n_global), n_global)
    c_local = min(c, n_local)
    fns = stage_fns(cfg.backend)
    b = q.shape[0]

    # ---- Stage 1: local batched approximate scoring + local proposals.
    keys, gids, queries = [], [], []
    for sid, db in enumerate(shards):
        dev = db.msb_plane.device
        offset = sid * n_local
        with current(dev):
            qd = q.to(dev)
            queries.append(qd)
            approx = fns.plane(quantization.msb_nibble(qd),
                               db.msb_plane)                # (B, n_local)
            if cfg.metric == "cosine":
                key1 = similarity.cosine_key_f32(approx, db.norms_sq[None, :])
            else:
                key1 = approx.to(torch.float32)
            # Pad rows (gid >= n_global, appended by pad_database) score 0,
            # which WINS whenever every real score is negative. -inf removes
            # them from the proposal ranking outright: every shard holds
            # enough real rows, so the global top-C is pad-free.
            real = (torch.arange(n_local, device=dev) + offset) < n_global
            key1 = key1.masked_fill(~real[None, :], float("-inf"))
            loc_key, loc_idx = similarity.stable_topk(key1, c_local)
            keys.append(loc_key.to(lead))
            gids.append((loc_idx + offset).to(torch.int32).to(lead))

    # ---- Tournament: the proposals on the lead device, shard-major per
    # lane (the order the reference's all_gather flattens them in), then
    # the global top-C per lane.
    all_key = torch.cat(keys, dim=1)                        # (B, S*c_local)
    all_gid = torch.cat(gids, dim=1)
    _, sel = similarity.stable_topk(all_key, c)
    cand_gid = torch.gather(all_gid, 1, sel)                # (B, C) int32

    # ---- Stage 2: exact rescoring by owners only, summed on the lead
    # device. The shard reads its candidates by local id (the reference
    # gathers the rows first; the bits are the same).
    exact = torch.zeros((b, c), dtype=torch.int32, device=lead)
    cand_norms = torch.zeros((b, c), dtype=torch.int32, device=lead)
    for sid, db in enumerate(shards):
        dev = db.msb_plane.device
        offset = sid * n_local
        with current(dev):
            gid = cand_gid.to(dev)
            owned = (gid >= offset) & (gid < offset + n_local)
            local_rows = torch.clamp(gid - offset, 0, n_local - 1)
            part = fns.exact(queries[sid], db.msb_plane, db.lsb_plane,
                             local_rows.to(torch.int32))    # (B, C) int32
            nrm = db.norms_sq[local_rows.long()]
            exact += part.masked_fill(~owned, 0).to(lead)
            cand_norms += nrm.masked_fill(~owned, 0).to(lead)
    # Defense in depth for the final rerank: should a pad gid ever reach
    # the candidate set, its exact score must not be the winning 0 (INT8
    # dots are bounded by 127^2 * D << 2^31, so INT32_MIN is a true floor;
    # norm 1 keeps the non-division cosine comparator well-posed).
    pad_cand = cand_gid >= n_global
    exact = exact.masked_fill(pad_cand, INT32_MIN)
    cand_norms = cand_norms.masked_fill(pad_cand, 1)

    # ---- Final rerank per lane (on "cuda" one kernel launch).
    indices, scores = fns.rerank(exact, cand_norms, cand_gid, k=cfg.k,
                                 metric=cfg.metric)
    return RetrievalResult(indices=indices, scores=scores,
                           candidate_indices=cand_gid)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedIndex:
    """A database split over a mesh's shard slots + a retrieval entry
    point. `db` holds one row block per slot, each on its slot's device."""

    db: tuple[bitplanar.BitPlanarDB, ...]
    mesh: Mesh
    n_global: int

    def __post_init__(self):
        for dev in self.mesh.slots():
            resolve_device(dev)          # a CUDA slot needs a CUDA device
        if len(self.db) != self.mesh.size:
            raise ValueError(f"{len(self.db)} row blocks for a mesh of "
                             f"{self.mesh.size} shard slots")

    @classmethod
    def build(cls, embeddings, mesh: Mesh) -> "ShardedIndex":
        """Quantize (N, D) float embeddings on the mesh's first device, pad
        to the slot count and split."""
        qdb = quantization.build_database(embeddings,
                                          device=mesh.slots()[0])
        bp = bitplanar.BitPlanarDB.from_quantized(qdb)
        n_global = bp.num_docs
        bp = pad_database(bp, mesh.size)
        return cls(db=shard_database(bp, mesh), mesh=mesh, n_global=n_global)

    def retrieve_fn(self, cfg: RetrievalConfig):
        """Returns f(query_codes (D,) or (B, D) int8) -> RetrievalResult on
        the mesh's first device."""
        from repro_torch.kernels import autotune
        for dev in dict.fromkeys(self.mesh.slots()):
            autotune.ensure_default_installed(dev)

        def retrieve(query_codes: torch.Tensor) -> RetrievalResult:
            if query_codes.ndim == 1:
                # a single query is a B=1 lane of the batch
                res = _tournament_retrieve(query_codes[None], self.db,
                                           cfg=cfg, n_global=self.n_global)
                return RetrievalResult(
                    indices=res.indices[0], scores=res.scores[0],
                    candidate_indices=res.candidate_indices[0])
            return _tournament_retrieve(query_codes, self.db, cfg=cfg,
                                        n_global=self.n_global)

        return retrieve
