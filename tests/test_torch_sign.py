"""The arithmetic of the dense sign scan's tensor-core kernel
(`sign_mma_kernel`, csrc/stage0_sign_mma.cu), emulated in plain PyTorch
on the CPU: the sign bits of each 32-bit plane word turned into s8 masks
(w << (7 - j)) & 0x80808080 (-128 * bit), eight m16n8k32 k-steps per
32-byte chunk against the query's eight sub-panels (byte c of sub-panel j
is q[8c + j]), int32 accumulators, and qsum + (acc >> 6). It must equal
the plain version and the reference Pallas kernel (interpret=True, as
tests/test_kernels.py runs it) bit for bit, for +-1 queries and for any
int8 query. The kernel itself runs in test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.stage0_sign import stage0_sign_batched_pallas
from repro_torch.kernels import ops, ref

CHUNK = 32      # plane bytes per k-step group (one ldmatrix of a row)
MASKS = 8       # k-steps per chunk: one per bit of a sign byte
INT32 = 2 ** 31


def _masks(words: torch.Tensor, j: int) -> torch.Tensor:
    """(..., W) 32-bit plane words (int64 holding uint32) -> (..., 4 W) s8
    bytes of (w << (7 - j)) & 0x80808080, in memory (little-endian)
    order: -128 where bit j of the byte is set, else 0."""
    m = (words << (7 - j)) & 0x80808080
    b = torch.stack([(m >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
    b = torch.where(b >= 128, b - 256, b)
    return b.reshape(*words.shape[:-1], -1)


def sign_mma_emulated(q: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """q (B, D) int8 (any values), plane (N, D/8) uint8 with D/8 % 16 == 0
    -> (B, N) int32, as sign_mma_kernel computes it: chunk by chunk, mask
    j = 0..7 in turn, each k-step's int8 products summed into an int32
    accumulator; rows and panels past D/8 zero to the chunk's end."""
    b, d = q.shape
    n, d8 = plane.shape
    assert d == 8 * d8 and d8 % 16 == 0
    pad = -d8 % CHUNK
    rows = torch.cat([plane, plane.new_zeros((n, pad))], 1).to(torch.int64)
    words = (rows.reshape(n, -1, 4)
             << torch.tensor([0, 8, 16, 24])).sum(-1)          # (N, W)
    # sub-panel j, byte c = q[8c + j]: q.view(B, D/8, 8).transpose(1, 2)
    sub = q.to(torch.int64).reshape(b, d8, 8).transpose(1, 2)  # (B, 8, D8)
    sub = torch.cat([sub, sub.new_zeros((b, MASKS, pad))], 2)
    qsum = q.to(torch.int64).sum(1)
    acc = torch.zeros((b, n), dtype=torch.int64)
    for c0 in range(0, d8 + pad, CHUNK):
        w = words[:, c0 // 4:(c0 + CHUNK) // 4]
        for j in range(MASKS):
            a = _masks(w, j)                                   # (N, 32)
            acc += sub[:, j, c0:c0 + CHUNK] @ a.T
            assert int(acc.abs().max()) < INT32                # s32 sums
    assert bool((acc % 128 == 0).all())                        # >> 6 exact
    out = qsum[:, None] + (acc >> 6)
    assert int(out.abs().max()) < INT32
    return out.to(torch.int32)


def _pad(a, mult):
    return np.concatenate([a, np.zeros((-a.shape[0] % mult,) + a.shape[1:],
                                       a.dtype)])


@pytest.mark.parametrize("query", ["pm1", "int8"])
@pytest.mark.parametrize("b,n,d", [(3, 77, 128), (5, 250, 384),
                                   (2, 129, 640)])
def test_sign_mma_arithmetic_matches_plain_and_pallas(b, n, d, query):
    """The emulated product against the plain version and the Pallas
    kernel, exactly, at D = 128 (one half-live chunk), 384 and 640 (a
    half-live last chunk of a second slab) and ragged N, with the
    wrapper's +-1 queries and with random int8 queries."""
    rng = np.random.default_rng(b * n + d + (query == "int8"))
    plane = rng.integers(0, 256, (n, d // 8)).astype(np.uint8)
    plane[0] = 0xFF                       # every dim negative
    plane[-1] = 0                         # every dim positive
    codes = rng.integers(-128, 128, (b, d)).astype(np.int8)
    codes[0] = -128                       # the s8 floor in every dim
    q = (np.asarray(ops.pack_query_signs(torch.from_numpy(codes)))
         if query == "pm1" else codes)
    got = sign_mma_emulated(torch.from_numpy(q), torch.from_numpy(plane))
    want = ref.stage0_sign_batched_ref(torch.from_numpy(q),
                                       torch.from_numpy(plane))
    assert got.dtype == torch.int32 and got.shape == (b, n)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    block = 64
    pallas = np.asarray(stage0_sign_batched_pallas(
        jnp.asarray(q), jnp.asarray(_pad(plane, block)), block_n=block,
        interpret=True))[:, :n]
    np.testing.assert_array_equal(got.numpy(), pallas)
    sq = q.astype(np.int64)
    bits = np.unpackbits(plane, axis=1, bitorder="little").astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), sq @ (1 - 2 * bits).T)


def test_sign_mma_masks_are_minus_128_times_each_bit():
    """Mask j of a word holds -128 exactly where bit j of each byte is
    set, so the eight masks of a word sum to -128 * popcount per byte."""
    w = torch.tensor([0x01FF80A5, 0x7F000102], dtype=torch.int64)
    total = torch.zeros((2, 4), dtype=torch.int64)
    for j in range(MASKS):
        m = _masks(w, j).reshape(2, 4)
        bytes_ = torch.stack([(w >> (8 * i)) & 0xFF for i in range(4)], -1)
        assert torch.equal(m, -128 * ((bytes_ >> j) & 1))
        total += m
    pop = [[bin(int(x)).count("1") for x in row] for row in
           torch.stack([(w >> (8 * i)) & 0xFF for i in range(4)], -1)]
    assert torch.equal(total, -128 * torch.tensor(pop))
