"""The register-level data movement of csrc/int8_mm.cu, csrc/cross_attn.cu
and csrc/flash_attn_bwd.cu, emulated lane by lane on the CPU: TMA's swizzled
shared-memory layouts, the 32-bit shared-memory reads, ``__byte_perm``, the
exact int8 -> bf16 step, ``ldmatrix``, the fragment layouts of
``mma.sync.m16n8k16``, and wgmma's: the operands it reads from shared
memory through a 128-byte-swizzle descriptor (K-major and MN-major), its
m64nN accumulators and their repacking into a register A operand. Each test
rebuilds what the kernel's lanes hand to the tensor cores and checks the
products against a plain matmul, so a wrong index or permutation shows here
before the kernels run on a card (where test_torch_kernels_cuda.py holds
them against their plain versions)."""

import numpy as np
import pytest

def byte_perm(x: int, y: int, s: int) -> int:
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def f32_bits(f) -> int:
    return int(np.array(f, np.float32).view(np.uint32))


def bits_f32(u: int) -> np.float32:
    return np.array(u, np.uint32).view(np.float32)


def bf16x2_of_i8_pair(w: int) -> int:
    """hopper.cuh:bf16x2_of_i8_pair: bf16x2 subtraction of the bit patterns
    (w & 0x007F007F) | 0x43004300 and (w & 0x00800080) | 0x43004300."""
    mag, off = (w & 0x007F007F) | 0x43004300, (w & 0x00800080) | 0x43004300
    out = 0
    for half in range(2):
        d = bf16_pair(mag)[half] - bf16_pair(off)[half]
        bits = f32_bits(d) >> 16
        assert float(bits_f32(bits << 16)) == d  # exact: nothing rounds
        out |= bits << (16 * half)
    return out


def bf16x4_of_i8x4(v: int) -> tuple[int, int]:
    """hopper.cuh:bf16x4_of_i8x4."""
    return bf16x2_of_i8_pair(byte_perm(v, 0, 0x0100)), bf16x2_of_i8_pair(byte_perm(v, 0, 0x0302))


def bf16_pair(word: int) -> tuple[float, float]:
    return float(bits_f32((word & 0xFFFF) << 16)), float(bits_f32(word & 0xFFFF0000))


def mma(a, b0, b1) -> np.ndarray:
    """D (16 x 8) of mma.sync m16n8k16 from the 32 lanes' registers:
    a[lane] = 4 words, b0[lane], b1[lane] one word each."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for lane in range(32):
        g, c = lane // 4, lane % 4
        for reg, (row, k) in enumerate([(g, 2 * c), (g + 8, 2 * c), (g, 2 * c + 8), (g + 8, 2 * c + 8)]):
            A[row, k : k + 2] = bf16_pair(a[lane][reg])
        B[2 * c : 2 * c + 2, g] = bf16_pair(b0[lane])
        B[2 * c + 8 : 2 * c + 10, g] = bf16_pair(b1[lane])
    return A @ B


def d_of_lane(D: np.ndarray, lane: int) -> list:
    g, c = lane // 4, lane % 4
    return [D[g, 2 * c], D[g, 2 * c + 1], D[g + 8, 2 * c], D[g + 8, 2 * c + 1]]


def tma_box(data: np.ndarray, row_bytes: int, swizzle: int) -> bytearray:
    """A (rows, row_bytes) uint8 box as TMA writes it to a 1,024-byte aligned
    buffer under the 64- or 128-byte swizzle (bits 7.. into bits 4..)."""
    mask = {64: 3, 128: 7}[swizzle]
    buf = bytearray(data.size)
    flat = data.reshape(-1)
    for off in range(data.size):
        buf[off ^ (((off >> 7) & mask) << 4)] = int(flat[off])
    return buf


def u32(buf: bytearray, off: int) -> int:
    return int.from_bytes(buf[off : off + 4], "little")


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even bf16 bit patterns of float32 values."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("v", [0x00000000, 0x7F80FF01, 0x12345678, 0x80818283, 0xFFFEFD7F])
def test_int8_to_bf16_is_exact(v):
    lo, hi = bf16x4_of_i8x4(v)
    want = [np.int8(np.uint8((v >> (8 * i)) & 0xFF)) for i in range(4)]
    assert bf16_pair(lo) + bf16_pair(hi) == tuple(float(x) for x in want)


@pytest.mark.parametrize("M", [1, 8, 40, 64])
def test_int8_mm_fragments_give_the_product(M):
    """One 64-row K chunk of one 128-channel CTA: every warp's W^T A
    fragments (swizzled 32-bit reads + byte permutes), x^T B fragments
    (ldmatrix over 144-byte rows) and the partial tile's store layout."""
    rng = np.random.default_rng(M)
    bm = 8 * -(-M // 8)
    w = rng.integers(-128, 128, (64, 128)).astype(np.int8)
    x_bits = bf16_bits(rng.standard_normal((M, 64)))
    wbuf = tma_box(w.view(np.uint8), 128, 128)
    xs = bytearray(bm * 144)  # rows beyond M stay zero
    for r in range(M):
        xs[r * 144 : r * 144 + 128] = x_bits[r].tobytes()
    part = np.zeros((bm, 132))
    for warp in range(16):
        cgrp, kk = warp & 3, warp >> 2  # channel group, k16 step of the chunk
        acc = np.zeros((2, 8, 32, 4))
        a = {0: [], 1: []}
        for lane in range(32):
            g, c = lane // 4, lane % 4
            w4 = []
            for t in range(4):
                r = kk * 16 + 2 * c + (t & 1) + (t >> 1) * 8
                off = r * 128 + cgrp * 32 + 4 * g
                w4.append(u32(wbuf, off ^ ((r & 7) << 4)))
            regs = [[0] * 4, [0] * 4]
            for t in range(2):
                for h in range(2):
                    sel = 0x0400 + 0x0101 * (2 * t + h)
                    regs[t][h] = bf16x2_of_i8_pair(byte_perm(w4[0], w4[1], sel))
                    regs[t][2 + h] = bf16x2_of_i8_pair(byte_perm(w4[2], w4[3], sel))
            a[0].append(regs[0])
            a[1].append(regs[1])
        for j in range(bm // 8):
            # ldmatrix: matrix mi's row r comes from lane 8 mi + r; lane t
            # receives bytes 4 (t % 4) .. of row t / 4 of each matrix.
            addr = [(8 * j + (ln & 7)) * 144 + (kk * 16 + ((ln >> 3) & 1) * 8) * 2 for ln in range(32)]
            b = [[u32(xs, addr[8 * mi + t // 4] + 4 * (t % 4)) for mi in range(2)] for t in range(32)]
            for t_ in range(2):
                D = mma(a[t_], [bb[0] for bb in b], [bb[1] for bb in b])
                for lane in range(32):
                    acc[t_, j, lane] += d_of_lane(D, lane)
        for lane in range(32):
            g, c = lane // 4, lane % 4
            for j in range(bm // 8):
                for h in range(2):
                    m = 8 * j + 2 * c + h
                    v = [acc[0, j, lane, h], acc[0, j, lane, 2 + h], acc[1, j, lane, h], acc[1, j, lane, 2 + h]]
                    part[m, cgrp * 32 + 4 * g : cgrp * 32 + 4 * g + 4] += v
    want = bf16_value(x_bits).astype(np.float64) @ w.astype(np.float64)
    np.testing.assert_allclose(part[:M, :128], want, rtol=1e-6, atol=1e-6)
    assert not part[M:, :128].any()


def _kv_box(kv_int8: bool, rng) -> tuple[np.ndarray, bytearray]:
    """A 16-position x 64-dim tile of K or V as its values and its swizzled
    bytes (the tile starts a multiple of 1,024 bytes into its chunk)."""
    if kv_int8:
        vals = rng.integers(-128, 128, (16, 64)).astype(np.int8)
        return vals.astype(np.float64), tma_box(vals.view(np.uint8), 64, 64)
    bits = bf16_bits(rng.standard_normal((16, 64)))
    return bf16_value(bits).astype(np.float64), tma_box(bits.view(np.uint8).reshape(16, 128), 128, 128)


@pytest.mark.parametrize("kv_int8", [True, False])
def test_cross_attn_logit_fragments_give_q_kt(kv_int8):
    rng = np.random.default_rng(1)
    k, buf = _kv_box(kv_int8, rng)
    q_bits = bf16_bits(rng.standard_normal((8, 64)))
    a_regs, qw = [], []
    for lane in range(32):
        g, c = lane // 4, lane % 4
        kr = [[0] * 8, [0] * 8]
        for h in range(2):
            if kv_int8:
                off = (g + 8 * h) * 64 + c * 16
                phys = off ^ (((off >> 7) & 3) << 4)
                words = [u32(buf, phys + 4 * i) for i in range(4)]
                for j in range(4):
                    kr[h][2 * j], kr[h][2 * j + 1] = bf16x4_of_i8x4(words[j])
            else:
                for p in range(2):
                    off = (g + 8 * h) * 128 + c * 32 + p * 16
                    phys = off ^ (((off >> 7) & 7) << 4)
                    for i in range(4):
                        kr[h][4 * p + i] = u32(buf, phys + 4 * i)
        a_regs.append(kr)
        qw.append([int(x) for x in q_bits[g, 16 * c : 16 * c + 16].view(np.uint32)])
    D = np.zeros((16, 8))
    for s in range(4):
        a = [[kr[0][2 * s], kr[1][2 * s], kr[0][2 * s + 1], kr[1][2 * s + 1]] for kr in a_regs]
        D += mma(a, [w[2 * s] for w in qw], [w[2 * s + 1] for w in qw])
    want = k @ bf16_value(q_bits).astype(np.float64).T  # (positions, query rows)
    np.testing.assert_allclose(D, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kv_int8", [True, False])
def test_cross_attn_value_fragments_give_vt_wt(kv_int8):
    rng = np.random.default_rng(2)
    v, buf = _kv_box(kv_int8, rng)
    w_bits = bf16_bits(rng.random((8, 16)))  # bf16 weights of 8 query rows x 16 positions
    pairs = w_bits.view(np.uint32)  # (8, 8): the pair of positions 2i, 2i + 1
    mask, row = (3, 64) if kv_int8 else (7, 128)
    out = np.zeros((8, 64))
    n_mma = 4
    a = [[None] * 32 for _ in range(n_mma)]
    for lane in range(32):
        g, c = lane // 4, lane % 4
        groups = 2 if kv_int8 else 4
        for e in range(groups):
            wd = []
            for t in range(4):
                r = 2 * c + (t & 1) + (t >> 1) * 8
                off = r * row + e * 32 + 4 * g
                wd.append(u32(buf, off ^ (((off >> 7) & mask) << 4)))
            if kv_int8:
                a[2 * e][lane] = [*bf16x4_of_i8x4(byte_perm(wd[0], wd[1], 0x5140)), *bf16x4_of_i8x4(byte_perm(wd[2], wd[3], 0x5140))]
                a[2 * e + 1][lane] = [*bf16x4_of_i8x4(byte_perm(wd[0], wd[1], 0x7362)), *bf16x4_of_i8x4(byte_perm(wd[2], wd[3], 0x7362))]
            else:
                a[e][lane] = [byte_perm(wd[0], wd[1], 0x5410), byte_perm(wd[0], wd[1], 0x7632),
                              byte_perm(wd[2], wd[3], 0x5410), byte_perm(wd[2], wd[3], 0x7632)]
    b0 = [int(pairs[lane // 4, lane % 4]) for lane in range(32)]  # positions 2c, 2c + 1
    b1 = [int(pairs[lane // 4, lane % 4 + 4]) for lane in range(32)]  # positions 2c + 8, 2c + 9
    for t in range(n_mma):
        D = mma(a[t], b0, b1)
        for lane in range(32):
            g, c = lane // 4, lane % 4
            d = d_of_lane(D, lane)
            for hh in range(2):
                dim = 32 * (t >> 1) + 4 * g + 2 * (t & 1) + hh if kv_int8 else 16 * t + 2 * g + hh
                out[2 * c, dim] += d[2 * hh]
                out[2 * c + 1, dim] += d[2 * hh + 1]
    want = bf16_value(w_bits).astype(np.float64) @ v
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)


# ---- wgmma (csrc/hopper.cuh, csrc/flash_attn_bwd.cu) ----


def sw128(addr: int) -> int:
    """The 128-byte swizzle on a byte address (tiles at 1,024-byte
    boundaries): the 16-byte chunk bits 4..6 XOR the row bits 7..9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def lds_sw128(buf: bytearray, row: int, col: int) -> int:
    """flash_attn_bwd.cu:lds_sw128: the word of elements (row, col), (row,
    col + 1) of a tile of 128-byte bf16 rows as TMA wrote it."""
    return u32(buf, row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2)


def bf16_at(buf: bytearray, addr: int) -> float:
    return float(bits_f32(int.from_bytes(buf[addr : addr + 2], "little") << 16))


def smem_operand(buf: bytearray, start: int, n: int, mn_major: bool) -> np.ndarray:
    """The 16 x n B operand (k16 step x n columns) that wgmma reads through
    hopper.cuh:sw128_desc at byte `start` (stride between 8-row groups 1,024):
    K-major, column j's 16 values run along a 128-byte row (row j); MN-major,
    row k of the step is a 128-byte row holding 64 columns."""
    B = np.zeros((16, n))
    for k in range(16):
        for j in range(n):
            if mn_major:
                addr = start + (k // 8) * 1024 + (k % 8) * 128 + 2 * j
            else:
                addr = start + (j // 8) * 1024 + (j % 8) * 128 + 2 * k
            B[k, j] = bf16_at(buf, sw128(addr))
    return B


def wgmma_rs(acc: np.ndarray, a: list, buf: bytearray, start: int, mn_major: bool) -> None:
    """acc (128 threads x n / 2) += A B for wgmma m64nNk16 with A from
    registers (a[thread] = 4 words) and B from shared memory."""
    n = acc.shape[1] * 2
    A = np.zeros((64, 16))
    for t in range(128):
        w, g, c = t // 32, (t % 32) // 4, t % 4
        for reg, (row, k) in enumerate([(g, 2 * c), (g + 8, 2 * c), (g, 2 * c + 8), (g + 8, 2 * c + 8)]):
            A[16 * w + row, k : k + 2] = bf16_pair(a[t][reg])
    D = A @ smem_operand(buf, start, n, mn_major)
    acc += [lane_values(D, t) for t in range(128)]


def lane_values(D: np.ndarray, t: int) -> list:
    """Thread t's m64nN accumulators: d[4j..4j+1] = D[16w+g][8j+2c..],
    d[4j+2..4j+3] = D[16w+g+8][8j+2c..]."""
    w, g, c = t // 32, (t % 32) // 4, t % 4
    out = []
    for j in range(D.shape[1] // 8):
        out += [D[16 * w + g, 8 * j + 2 * c], D[16 * w + g, 8 * j + 2 * c + 1],
                D[16 * w + g + 8, 8 * j + 2 * c], D[16 * w + g + 8, 8 * j + 2 * c + 1]]
    return out


def matrix_of(acc: np.ndarray) -> np.ndarray:
    D = np.zeros((64, acc.shape[1] * 2))
    for t in range(128):
        w, g, c = t // 32, (t % 32) // 4, t % 4
        for j in range(D.shape[1] // 8):
            D[16 * w + g, 8 * j + 2 * c : 8 * j + 2 * c + 2] = acc[t, 4 * j : 4 * j + 2]
            D[16 * w + g + 8, 8 * j + 2 * c : 8 * j + 2 * c + 2] = acc[t, 4 * j + 2 : 4 * j + 4]
    return D


def pack_bf16(lo: float, hi: float) -> int:
    return int(bf16_bits(np.float32(lo))) | int(bf16_bits(np.float32(hi))) << 16


def pack_a(x: np.ndarray) -> list:
    """flash_attn_bwd.cu:pack_a (flash_attn.cu:pack_p): a thread's
    accumulators, rounded to bf16, as the A words of k16 steps kc = 0.."""
    return [pack_bf16(x[2 * i], x[2 * i + 1]) for i in range(len(x) // 2)]


def load_a(buf: bytearray, t: int) -> list:
    """flash_attn_bwd.cu:load_a: rows r0 and r0 + 8 of a resident 64-row
    tile as the A words of its four k16 steps."""
    w, g, c = t // 32, (t % 32) // 4, t % 4
    r0, c2 = 16 * w + g, 2 * c
    return [lds_sw128(buf, r0 + 8 * (i & 1), 16 * kc + 8 * (i >> 1) + c2) for kc in range(4) for i in range(4)]


def bf16_tile(rng, rows: int, scale: float = 1.0) -> tuple[np.ndarray, bytearray]:
    """A (rows, 64) bf16 tile: its values and its bytes as a TMA box."""
    bits = bf16_bits(rng.standard_normal((rows, 64)) * scale)
    return bf16_value(bits).astype(np.float64), tma_box(bits.view(np.uint8).reshape(rows, 128), 128, 128)


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("resident", ["keys", "queries"])
def test_flash_bwd_fragments_give_logits_and_accumulation(resident, width):
    """One consumer warpgroup of either backward kernel: its 64 resident
    rows (dK/dV: keys; dQ: query rows) read from their swizzled tile as A
    fragments; the transposed product with a streamed tile of `width` rows
    read K-major (S^T = K Q^T, or S = Q K^T); then the accumulators, scaled
    and rounded to bf16, repacked as the A operand of the accumulating
    product with a second streamed tile read MN-major through the transpose
    flag (dV += bf16(P^T) dO, or dQ += bf16(dS) K) in k16 steps of 2,048
    bytes."""
    rng = np.random.default_rng(width + (resident == "keys"))
    res, res_buf = bf16_tile(rng, 64, 0.35)
    streamed, streamed_buf = bf16_tile(rng, width, 0.35)
    other, other_buf = (streamed, streamed_buf) if resident == "queries" else bf16_tile(rng, width)
    a = [load_a(res_buf, t) for t in range(128)]
    acc = np.zeros((128, width // 2))
    for kk in range(4):  # the head dim's k16 steps: 32 bytes along each row
        wgmma_rs(acc, [x[4 * kk : 4 * kk + 4] for x in a], streamed_buf, 32 * kk, mn_major=False)
    np.testing.assert_allclose(matrix_of(acc), res @ streamed.T, rtol=1e-6, atol=1e-6)

    x = np.exp(acc.astype(np.float32) - 1.0)  # stands for P^T (or dS): any fp32 values
    p = [pack_a(x[t]) for t in range(128)]
    out = np.zeros((128, 32))
    for kc in range(width // 16):  # the streamed rows' k16 steps
        wgmma_rs(out, [w[4 * kc : 4 * kc + 4] for w in p], other_buf, 2048 * kc, mn_major=True)
    want = bf16_value(bf16_bits(matrix_of(x.astype(np.float64)))).astype(np.float64) @ other
    np.testing.assert_allclose(matrix_of(out), want, rtol=1e-6, atol=1e-6)


def test_flash_bwd_delta_from_fragments():
    """flash_attn_bwd.cu's D = Σ dO·O in the dQ kernel: each thread's dO A
    words and the O words at the same places give 16 dims of rows r0 and
    r0 + 8; the sum over the four threads of a row (lane xor 1, 2) is the
    whole row's."""
    rng = np.random.default_rng(7)
    do, do_buf = bf16_tile(rng, 64)
    o, o_buf = bf16_tile(rng, 64)
    part = np.zeros((128, 2))
    for t in range(128):
        c2 = 2 * (t % 4)
        r0 = 16 * (t // 32) + (t % 32) // 4
        da = load_a(do_buf, t)
        for kc in range(4):
            for i in range(4):
                ow = lds_sw128(o_buf, r0 + 8 * (i & 1), 16 * kc + 8 * (i >> 1) + c2)
                d2, o2 = bf16_pair(da[4 * kc + i]), bf16_pair(ow)
                part[t, i & 1] += d2[0] * o2[0] + d2[1] * o2[1]
    for t in range(128):
        r0 = 16 * (t // 32) + (t % 32) // 4
        got = part[t ^ 0] + part[t ^ 1] + part[t ^ 2] + part[t ^ 3]
        np.testing.assert_allclose(got, [(do[r0] * o[r0]).sum(), (do[r0 + 8] * o[r0 + 8]).sum()], rtol=1e-9, atol=1e-9)
