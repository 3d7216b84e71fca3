// Per-row big-integer chains on u32 limbs for Hopper (sm_90a).
//
// Replaces, on CUDA tensors, the torch chains of gpqhe_tpu_torch/ops/limbs.py
// that XLA fuses inside each jitted program of the JAX package
// (gpqhe_tpu/ops/limbs.py: add 44, add_scalar_bit 55, sub 68, neg, geq_const
// 87, mask_bits 111, rshift_round 144, select, from_digits16 210), plus the
// rescale composite rshift_round -> mask_bits -> resize of the scheme
// engine (gpqhe_tpu/scheme/engine.py:515-519).  In torch the carries and
// borrows are log-depth Kogge-Stone scans of some 10-30 launches an op; here
// every op is one launch.
//
// Layout: a limb tensor [..., K] (u32 values in int64) is seen as rows
// [R1, R2] of K limbs with strides (s1, s2, sk), so broadcast operands (a
// constant's [K] limbs) and views are read in place; a per-row operand (a
// bit, a mask) likewise, with a dtype flag (bool or int64).  Outputs are
// contiguous.
//
// What bounds it on the H100: bytes (a few integer operations per limb word
// read and written).  Two designs, both reading and writing neighbouring
// words across a warp:
//   - the chains (add, sub, neg, add_scalar_bit, geq_const, the shifts, the
//     rescale, from_digits16): a warp per row group (rowwarp.cuh), lane i of
//     a group limb i of its row, rows of more than 32 limbs (geq_const's 62-125)
//     walked by the whole warp 32 limbs at a time; a chunk's carries or
//     borrows come from two ballots ((X + Y + C) ^ X ^ Y over the lanes'
//     generate and propagate bits, C the carry out of the chunk before),
//     geq_const from the highest lane where the operands differ, walking
//     the chunks from the top and stopping once every row of the warp has
//     met a difference (a row that differs in its top chunk reads no
//     other), the shifts take limbs s + i and s + i + 1 by shuffle and
//     their rounding bit from a ballot of the limbs below it, and
//     from_digits16's multi-bit digit carries are first brought to 0/1 by
//     two shuffles up a lane; no shared memory, no barrier;
//   - mask_bits and select, which have no chain: one thread a word of the
//     flattened output, or two neighbouring limbs of a row as one 16-byte
//     access where every limb operand allows it.
// A per-row operand (the bit, the mask) is read by the lanes of its row.
// The first design, one thread walking its row in global memory, read
// words K apart across a warp and ran at 4.2-7.8x its byte bound; a block's
// rows staged through shared memory (all its loads, then one thread a row
// walking there, then the stores, in lockstep over the card) stayed at 1.8x
// torch's `a & m` for add (PERF.md).
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include "rowwarp.cuh"

enum {
    OP_ADD = 0, OP_SUB = 1, OP_NEG = 2, OP_ADD_BIT = 3, OP_MASK = 4, OP_RSHIFT_ROUND = 5,
    OP_RESCALE = 6, OP_GEQ = 7, OP_SELECT = 8, OP_FROM_DIGITS = 9
};

struct Rows {
    const void *p;
    i64 s1, s2, sk;
    int kind;              // 0: int64 words, 1: f64 values, 2: bool bytes
    // word offset of row `row` of the [R1, R2] rows
    __device__ __forceinline__ i64 row_off(unsigned row, FastDiv R2) const {
        if (s1 == s2 * R2.d) return row * s2;      // the two row axes collapse
        const unsigned r1 = R2.div(row);
        return r1 * s1 + (row - r1 * R2.d) * s2;
    }
    __device__ __forceinline__ u64 word(i64 o) const {
        if (kind == 1) return (u64)(i64)__ldg((const double *)p + o);
        if (kind == 2) return (u64)__ldg((const unsigned char *)p + o);
        return (u64)__ldg((const i64 *)p + o);
    }
    __device__ __forceinline__ u64 at(unsigned row, FastDiv R2, int i) const {
        return word(row_off(row, R2) + i * sk);
    }
};

// rows R1 * R2 < 2^31 (and, for mask_bits and select, words R1 * R2 * K)
struct Args {
    unsigned rows;
    FastDiv R2, Kd;        // dividers by R2 and (K, at least 1)
    int K, k_out, t, nbits;
};

// The chains: a warp per row group (rowwarp.cuh, LaneGroups), lane i of a
// group limb c0 + i of its row in chunk c0 (one chunk for rows of at most
// 32 limbs; of the output for from_digits16, whose lane reads digits 2i and
// 2i + 1), the carry, borrow or verdict of each row passed from chunk to
// chunk in a register: upwards, or for geq_const from the top chunk down
// until every row of the warp has met a difference.  CHUNKED: L > 32 (the
// one-chunk rows compile to straight-line code).  Limbs below 2^32.
template <int OP, bool CHUNKED>
__global__ void __launch_bounds__(ROWWARP_THREADS)
limbs_row_kernel(void *out, Args g, Rows a, Rows b, Rows bit) {
    const int K = g.K, k_out = g.k_out;
    const int L = OP == OP_FROM_DIGITS || k_out > K ? k_out : K;
    const int nch = CHUNKED ? (L + 31) / 32 : 1;
    const LaneGroups lg(L);
    const unsigned warp = blockIdx.x * (ROWWARP_THREADS / 32) + (threadIdx.x >> 5);
    const unsigned row0 = warp * (WARP_GROUPS * lg.G) + lg.grp;
    constexpr bool uses_b = OP == OP_ADD || OP == OP_SUB || OP == OP_GEQ,
                   shift = OP == OP_RSHIFT_ROUND || OP == OP_RESCALE;
    // b one constant row (geq_const's c): its limb read once a chunk
    const bool b_row = uses_b && b.s1 == 0 && b.s2 == 0;
    // the shifts: quotient limb i from limbs s + i and s + i + 1, lane j of
    // the chunks cur and nxt holding limbs sb + c0 + j and sb + c0 + 32 + j;
    // the rounding bit is bit hb of limb hl, with any bit below it
    const int s = g.t / 32, r = g.t % 32, sb = s / 32 * 32, sr = s % 32;
    const int hl = g.t > 0 ? (g.t - 1) / 32 : 0, hb = g.t > 0 ? (g.t - 1) % 32 : 0,
              nlow = g.t > 0 ? (hl < K ? hl : K) : 0;
    const int full = g.nbits / 32, rem = g.nbits % 32;
    // each row's carry (or borrow) into the next chunk, geq's verdict, from_digits16's carries
    u64 c[WARP_GROUPS], nxt[WARP_GROUPS];
    bool ge[WARP_GROUPS], done[WARP_GROUPS];
    DigitCarry dc[WARP_GROUPS];
#pragma unroll
    for (int u = 0; u < WARP_GROUPS; ++u) {
        const unsigned row = row0 + u * lg.G;
        const bool live = lg.grp < lg.G && row < g.rows;
        c[u] = 0;
        nxt[u] = 0;
        ge[u] = true;
        done[u] = !live;
        dc[u] = {0, 0, 0};
        if (OP == OP_ADD_BIT) {
            // every lane reads its row's bit (row 0 past the end): no load under a branch
            const u64 on = bit.at(row < g.rows ? row : 0, g.R2, 0);
            c[u] = live && on != 0;
        }
    }
    for (int n = 0; n < nch; ++n) {
        const int c0 = 32 * (OP == OP_GEQ ? nch - 1 - n : n), li = c0 + lg.i;
        const u64 yc = b_row && lg.grp < lg.G && li < K ? b.word((i64)li * b.sk) : 0;
        u64 x[WARP_GROUPS], y[WARP_GROUPS];
#pragma unroll
        for (int u = 0; u < WARP_GROUPS; ++u) {
            const unsigned row = row0 + u * lg.G;
            const bool live = lg.grp < lg.G && row < g.rows, in = live && li < K;
            if (OP == OP_FROM_DIGITS) {
                x[u] = live && li < k_out && 2 * li < K ? a.at(row, g.R2, 2 * li) : 0;
                y[u] = live && li < k_out && 2 * li + 1 < K ? a.at(row, g.R2, 2 * li + 1) : 0;
            } else if (shift) {
                const int j = sb + li;
                x[u] = c0 ? nxt[u] : live && j < K ? a.at(row, g.R2, j) : 0;
                if (CHUNKED) nxt[u] = live && j + 32 < K ? a.at(row, g.R2, j + 32) : 0;
            } else {
                x[u] = in ? a.at(row, g.R2, li) : 0;
                y[u] = uses_b ? (b_row ? yc : in ? b.at(row, g.R2, li) : 0) : 0;
            }
        }
        if (shift && c0 == 0 && g.t > 0) {
#pragma unroll
            for (int u = 0; u < WARP_GROUPS; ++u) {
                const unsigned row = row0 + u * lg.G;
                const bool live = lg.grp < lg.G && row < g.rows;
                // limb hl and the limbs below it: in the first chunk where sb is 0
                // (hl <= s < 32), else read 32 at a time
                u64 h = __shfl_sync(~0u, x[u], (lg.base + hl) & 31);
                unsigned nz = __ballot_sync(~0u, !sb && lg.i < nlow && x[u] != 0) & lg.mask();
                if (sb) h = live && hl < K ? a.at(row, g.R2, hl) : 0;
                else if (hl >= K) h = 0;
                for (int c1 = sb ? 0 : 32; c1 < nlow; c1 += 32) {
                    const bool on = live && c1 + lg.i < nlow;
                    nz |= __ballot_sync(~0u, on && a.at(row, g.R2, c1 + lg.i) != 0) & lg.mask();
                }
                const bool low = (hb > 0 && (h & ((1ull << hb) - 1)) != 0) || nz;
                c[u] = live && (h >> hb & 1) && low;
            }
        }
        bool all_done = true;
#pragma unroll
        for (int u = 0; u < WARP_GROUPS; ++u) {
            const unsigned row = row0 + u * lg.G;
            const bool live = lg.grp < lg.G && row < g.rows, in = live && li < K;
            if (OP == OP_GEQ) {
                lane_geq(lg, in, x[u], y[u], ge[u], done[u]);
                all_done = all_done && done[u];
                continue;
            }
            u64 w;
            if (OP == OP_ADD) {
                w = lane_add(lg, in, x[u], y[u], c[u]);
            } else if (OP == OP_SUB) {
                w = lane_sub(lg, in, x[u], y[u], c[u]);
            } else if (OP == OP_NEG) {
                w = lane_sub(lg, in, 0, x[u], c[u]);
            } else if (OP == OP_ADD_BIT) {
                w = (x[u] + lane_chain(lg, false, in && x[u] == M32, c[u])) & M32;
            } else if (OP == OP_FROM_DIGITS) {
                w = lane_digits(lg, live && li < k_out, x[u], y[u], dc[u], CHUNKED);
            } else {
                // limb sb + c0 + j: lane j of cur (j < 32) or of nxt, 0 past the row
                auto limb = [&](int j) {
                    const u64 lo = __shfl_sync(~0u, x[u], (lg.base + j) & 31),
                              hi = CHUNKED ? __shfl_sync(~0u, nxt[u], j & 31) : 0;
                    return sb + c0 + j < K ? (j < 32 ? lo : hi) : 0ull;
                };
                const u64 q0 = limb(lg.i + sr), q1 = limb(lg.i + sr + 1);
                const u64 q = r ? ((q0 >> r) | (q1 << (32 - r))) & M32 : q0;
                w = (q + lane_chain(lg, false, live && li < k_out && q == M32, c[u])) & M32;
                // the rescale: rshift_round to K limbs, keep the low nbits, resize to k_out
                if (OP == OP_RESCALE)
                    w = li >= K ? 0
                        : li < full ? w : (li == full && rem ? w & ((1ull << rem) - 1) : 0);
            }
            if (live && li < k_out) ((u64 *)out)[(i64)row * k_out + li] = w;
        }
        if (OP == OP_GEQ && __all_sync(~0u, all_done)) break;
    }
    if (OP == OP_GEQ) {
#pragma unroll
        for (int u = 0; u < WARP_GROUPS; ++u) {
            const unsigned row = row0 + u * lg.G;
            if (lg.grp < lg.G && row < g.rows && lg.i == 0) ((unsigned char *)out)[row] = ge[u];
        }
    }
}

// mask_bits and select: one thread a word of the flattened [R1 * R2, K]
// output, or with PAIRS (K even, every limb operand's limbs contiguous and
// its rows 16-byte aligned) two neighbouring limbs of a row as one 16-byte
// access: 16 bytes a thread, as torch's own strided elementwise kernel takes.
template <int OP, bool PAIRS>
__global__ void __launch_bounds__(ROWWARP_THREADS)
limbs_word_kernel(u64 *out, Args g, Rows a, Rows b, Rows bit) {
    constexpr int V = PAIRS ? 2 : 1;
    const unsigned e = blockIdx.x * ROWWARP_THREADS + threadIdx.x;
    if (e >= g.rows * g.K / V) return;
    const unsigned row = g.Kd.div(e);
    const int i = (int)(e - row * (g.K / V)) * V;
    // every operand loaded whatever the word becomes: no load waits on another
    u64 x[V], y[V];
    if (PAIRS) {
        const ulonglong2 xa = __ldg((const ulonglong2 *)a.p + (a.row_off(row, g.R2) + i) / 2);
        x[0] = xa.x;
        x[V - 1] = xa.y;
        if (OP == OP_SELECT) {
            const ulonglong2 yb = __ldg((const ulonglong2 *)b.p + (b.row_off(row, g.R2) + i) / 2);
            y[0] = yb.x;
            y[V - 1] = yb.y;
        }
    } else {
        x[0] = a.at(row, g.R2, i);
        if (OP == OP_SELECT) y[0] = b.at(row, g.R2, i);
    }
    const bool take_a = OP == OP_SELECT && bit.at(row, g.R2, 0) != 0;
    const int full = g.nbits / 32, rem = g.nbits % 32;
    u64 v[V];
#pragma unroll
    for (int h = 0; h < V; ++h) {
        if (OP == OP_MASK)
            v[h] = i + h < full ? x[h] : (i + h == full && rem ? x[h] & ((1ull << rem) - 1) : 0);
        else
            v[h] = take_a ? x[h] : y[h];
    }
    if (PAIRS)
        ((ulonglong2 *)out)[e] = make_ulonglong2(v[0], v[V - 1]);
    else
        out[e] = v[0];
}

// a, b: limb rows [R1, R2, K] (b unused by NEG, ADD_BIT, MASK and the shifts);
// bit: per-row operand [R1, R2] (ADD_BIT's bit, SELECT's mask).  out:
// contiguous [R1 * R2, k_out] int64 limbs, or [R1 * R2] bytes for GEQ.  For
// FROM_DIGITS, K counts the digits of a.
extern "C" int gpqhe_limbs(int op, i64 R1, i64 R2, int K, int k_out, int t, int nbits,
                           void *out, const void *a, i64 a1, i64 a2, i64 ak, int akind,
                           const void *b, i64 b1, i64 b2, i64 bk,
                           const void *bit, i64 t1, i64 t2, int tkind, void *stream) {
    const i64 rows = R1 * R2;
    const bool per_word = op == OP_MASK || op == OP_SELECT;
    if (R1 < 1 || R2 < 1 || K < 0 || (per_word ? rows * K : rows) >= (1ll << 31))
        return (int)cudaErrorInvalidValue;
    const Args g = {(unsigned)rows, FastDiv::of((unsigned)R2), FastDiv::of(K > 0 ? K : 1),
                    K, k_out, t, nbits};
    // with one leading row, r1 is 0: let the row axes collapse
    const Rows A = {a, R1 == 1 ? a2 * R2 : a1, a2, ak, akind},
               B = {b, R1 == 1 ? b2 * R2 : b1, b2, bk, 0},
               T = {bit, R1 == 1 ? t2 * R2 : t1, t2, 0, tkind};
    cudaStream_t st = (cudaStream_t)stream;
    if (per_word) {
        // pairs of limbs where every limb operand allows 16-byte accesses
        auto pairs_ok = [&](const Rows &x) {
            return x.sk == 1 && x.s1 % 2 == 0 && x.s2 % 2 == 0 && (uintptr_t)x.p % 16 == 0;
        };
        const bool pairs = K % 2 == 0 && pairs_ok(A) && (op == OP_MASK || pairs_ok(B));
        Args gp = g;
        if (pairs) gp.Kd = FastDiv::of(K / 2);
        const i64 per_block = ROWWARP_THREADS * (pairs ? 2 : 1);
        const unsigned blocks = (unsigned)((rows * K + per_block - 1) / per_block);
#define WORDS(OPC, P) limbs_word_kernel<OPC, P><<<blocks, ROWWARP_THREADS, 0, st>>>( \
        (u64 *)out, gp, A, B, T)
        if (op == OP_MASK) { if (pairs) WORDS(OP_MASK, true); else WORDS(OP_MASK, false); }
        else { if (pairs) WORDS(OP_SELECT, true); else WORDS(OP_SELECT, false); }
#undef WORDS
        return (int)cudaGetLastError();
    }
    // the limbs a row walks: its output's for from_digits16 and a widening shift
    const int L = op == OP_FROM_DIGITS || k_out > K ? k_out : K;
    const unsigned per_block = rows_a_block(L, WARP_GROUPS);
    const unsigned blocks = (unsigned)((rows + per_block - 1) / per_block);
    switch (op) {
#define CASE(OPC) case OPC:                                                            \
        if (L > 32)                                                                     \
            limbs_row_kernel<OPC, true><<<blocks, ROWWARP_THREADS, 0, st>>>(out, g, A, B, T); \
        else                                                                            \
            limbs_row_kernel<OPC, false><<<blocks, ROWWARP_THREADS, 0, st>>>(out, g, A, B, T); \
        break;
        CASE(OP_ADD) CASE(OP_SUB) CASE(OP_NEG) CASE(OP_ADD_BIT) CASE(OP_RSHIFT_ROUND)
        CASE(OP_RESCALE) CASE(OP_GEQ) CASE(OP_FROM_DIGITS)
#undef CASE
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
