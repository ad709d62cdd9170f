"""One turn of the two kernel routes redesigned together, #6's resident
gather and #1 at one shard's rows, in one tree of the port, on the card.

    python3 tools/route_turns.py [--src DIR] [--sweep]

`--src` names the tree's `src` directory (default: this checkout's), so
the same measurement runs in a parent's tree unpacked beside this one
(`git archive` into `build/parent`) and in this tree, in turns, in one
process each: the tree's `repro_torch` is imported first, and the helpers
of this checkout's `chip_smoke.py` then measure it through the wrappers
both trees have. Prints the card, then per route and shape: the event
time of one call and of its library yardstick (`time_ms`, as the kernels
line takes them, and in turns), the device-only time (`kernel_device_us`,
as the kernels line takes it, and per launch over traces), and for #6 the
host microseconds per call over HOST_ROUNDS rounds of back-to-back calls;
with `--sweep` #1's device-only time over plane sizes at every tile.
Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_ROUNDS = 9            # rounds of back-to-back calls per host reading
RESIDENT_SLOTS = 2010      # slab slots of the warm serving run's cache
TURN_ROWS = (131072, 349526, 1 << 20)   # #1's plane rows: S = 8, 3, 1


def _times(cs, fn, lib) -> str:
    """The event times of `fn` and of its yardstick `lib`, each alone and
    in turns."""
    return (f"kernel_ms {cs.time_ms(fn):.4f} library_ms "
            f"{cs.time_ms(lib):.4f}{cs._turns_note(fn, lib)}")


def resident(cs, card: str, dev) -> None:
    """#6's resident route on a combined plane of the warm serving run's
    shape (N + RESIDENT_SLOTS * T_BLOCK_ROWS rows, ids in both regions),
    against `torch.bmm`; then the same kernel at the cluster path's shape
    (B = 32 lanes of 8 probed clusters of 16 blocks, the arena plane
    alone)."""
    torch, ops, ref = cs.torch, cs.ops, cs.ref
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
    br, d2, b, d = cs.T_BLOCK_ROWS, cs.D // 2, cs.B, cs.D
    nb = cs.N // br
    comb = torch.randint(0, 256, (cs.N + RESIDENT_SLOTS * br, d2),
                         generator=gen, device=dev, dtype=torch.uint8)
    ids = cs._resident_ids(gen, dev, nb, RESIDENT_SLOTS)
    q_msb = cs.quantization.msb_nibble(torch.randint(
        -128, 128, (b, d), generator=gen, device=dev, dtype=torch.int8))

    def fn():
        return ops.stage1_scores_gather_resident(q_msb, comb, ids,
                                                 block_rows=br)
    want = ref.stage1_gather_resident_ref(ops.pack_queries_even_odd(q_msb),
                                          comb, ids, br)
    if not torch.equal(fn(), want):
        raise AssertionError("resident gather differs from its plain version")
    view = cs.bitplanar.expand_block_rows(ids, br)
    operand = cs.bitplanar.unpack_nibble_plane_signed(
        comb[view.long()].reshape(-1, d2)).reshape(b, -1, d).float()
    col = q_msb.float()[:, :, None]

    def lib():
        return torch.bmm(operand, col)
    cs._check_library("stage1_gather_resident", lib, want)
    cs.log(f"turn stage1_gather_resident ({card}): {_times(cs, fn, lib)} "
           f"(torch.bmm); device_only_us "
           f"{cs.kernel_device_us(fn, 'gather_tma_kernel')}, per launch "
           f"{cs._device_us(fn, 'gather_tma_kernel', rounds=5)}; "
           f"host_us_per_call "
           f"{cs._host_us(fn, rounds=HOST_ROUNDS)} (median of "
           f"{HOST_ROUNDS} rounds of {cs.HOST_CALLS} calls); bit-exact")
    del operand
    plane, ids = comb[:cs.N], cs._cluster_like_ids(gen, dev)

    def cluster():
        return ops.stage1_scores_gather(q_msb, plane, ids, block_rows=br)
    if not torch.equal(cluster(), ref.stage1_gather_batched_ref(
            ops.pack_queries_even_odd(q_msb), plane, ids, br)):
        raise AssertionError("plane gather differs from its plain version")
    cs.log(f"turn stage1_gather@cluster ({card}): kernel_ms "
           f"{cs.time_ms(cluster):.4f} device_only_us "
           f"{cs.kernel_device_us(cluster, 'gather_tma_kernel')}, per launch "
           f"{cs._device_us(cluster, 'gather_tma_kernel', rounds=5)}; "
           "bit-exact")
    del comb, plane
    torch.cuda.empty_cache()


def plane_scan(cs, card: str, dev, sweep: bool) -> None:
    """#1 on the tensor-core kernel at each of TURN_ROWS plane rows (B =
    32, the default tile) against `torch._int_mm` on the pre-unpacked rows
    (columns padded to a multiple of 8, as it requires); the sweep on
    request."""
    torch, ops, ref = cs.torch, cs.ops, cs.ref
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 14)
    b, d = cs.B, cs.D
    q_msb = cs.quantization.msb_nibble(torch.randint(
        -128, 128, (b, d), generator=gen, device=dev, dtype=torch.int8))
    panel = ops.pack_query_panel(q_msb)
    for n in TURN_ROWS:
        plane = torch.randint(0, 256, (n, d // 2), generator=gen,
                              device=dev, dtype=torch.uint8)

        def fn(plane=plane):
            return cs.stage1_int4_batched(panel, plane)
        want = fn()
        if not torch.equal(want, ref.stage1_scores_batched_ref(panel, plane)):
            raise AssertionError(f"#1 at {n} rows differs from its plain "
                                 "version")
        n8 = -(-n // 8) * 8
        unpacked = torch.zeros((n8, d), dtype=torch.int8, device=dev)
        unpacked[:n] = cs.bitplanar.unpack_nibble_plane_signed(plane)
        unpacked_t = unpacked.t()

        def lib():
            return torch._int_mm(q_msb, unpacked_t)
        if not torch.equal(lib()[:, :n], want):
            raise AssertionError(f"torch._int_mm disagrees with #1 at {n} "
                                 "rows")
        moved = 2 * b * (d // 2) + n * (d // 2) + b * n * 4
        t_bound, by = cs.bound_ms(moved, 2 * b * n * d)
        floor = t_bound * 1e3 if moved > cs.L2_BYTES else 0.0
        symbol = "::plane_mma_kernel<"
        cs.log(f"turn stage1_plane_mma@shard n_local={n} ({card}): "
               f"{_times(cs, fn, lib)} (torch._int_mm, {n8} columns); "
               f"device_only_us {cs.kernel_device_us(fn, symbol)}, per "
               f"launch {cs._device_us(fn, symbol, floor, rounds=5)}; "
               f"bound_us {t_bound * 1e3:.2f} ({by}); bit-exact")
        del plane, unpacked, unpacked_t
        torch.cuda.empty_cache()
    if sweep:
        cs._plane_sweep(card, q_msb, rounds=3)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=os.path.join(ROOT, "src"))
    parser.add_argument("--sweep", action="store_true")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    import repro_torch  # noqa: F401  the tree measured, imported first
    if not torch.cuda.is_available():
        print("route_turns: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    t0 = time.perf_counter()
    card = cs.phase_card()
    cs.log(f"route_turns: the tree {os.path.abspath(args.src)} "
           f"({os.path.dirname(repro_torch.__file__)})")
    dev = torch.device("cuda", 0)
    resident(cs, card, dev)
    plane_scan(cs, card, dev, args.sweep)
    cs.log(f"route_turns: done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
