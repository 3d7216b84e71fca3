// RNS decompose and the CRT reconstruct, for Hopper (sm_90a).
//
// Replaces, on CUDA tensors, the torch chains of gpqhe_tpu_torch/ops/rns.py
// that XLA fuses inside each jitted program of the JAX package:
//   decompose    gpqhe_tpu/ops/rns.py:110 decompose_core (and the signed form
//                of gpqhe_tpu_torch/ring/poly.py, the JAX ring engine's
//                _decompose_signed): limbs [S, n, K] -> residues [S, dim, n];
//   digit_split  the first half of gpqhe_tpu/ops/rns.py:200 reconstruct_core,
//                the 16-bit digit split and the f64 digit matmul in one:
//                residues y -> the digit sums of S = sum_d y_d phat_d as
//                int64 [S, n, kd], by u8 products on the tensor cores, and
//                the estimate af = sum_d y_d / p_d;
//   lift         its second half: the digit sums and af -> limbs, with the
//                alpha correction, the 16-bit carry walk and either the fast
//                path (frac > 1/2 -> -P) or the exact path (+-P, then
//                centring).
// In torch a decompose of a 14-limb poly into 16 primes is ~440 launches and a
// reconstruct ~130; here a decompose is one launch and a reconstruct two
// (digit_split, lift).
//
// What bounds them on the H100: bytes for digit_split and lift (a word in,
// its digit sums out, 8 bytes each; a row of digit sums in, u32 limbs out, in
// int64), the tensor cores' u8 products close behind digit_split's bytes;
// multiplies for decompose's IMAD route: per output word and limb the 32 x
// 64-bit product of the limb and its constant, 2 IMAD and 2 IMAD.HI where the
// primes pass 32 bits, so that its work an output grows with the row's limbs
// K; its tensor-core route (rows of many limbs, see the kernel) takes those
// products as u8 ones.  The designs.  decompose: a block stages a tile of 64 rows'
// limbs in shared memory once, read coalesced, a signed row's limbs masked
// as they land; its 8 warps take 2 primes each of a tile of 16 and a lane 2
// rows, each output the sum over the limbs of limb_i c_i, c_i = 2^(32 i) R
// mod p made in the block from the weights, in four 32-bit words by a PTX
// carry chain, and one Montgomery reduction (the earlier design did K/2
// Montgomery products and modular adds an output, each thread re-reading
// its row from L2 for every 2 primes; PERF.md has both and the designs
// tried between, on the tensor cores among them).  digit_split: see the
// kernel.  The lift reads and writes neighbouring words across a warp
// (rowwarp.cuh): a warp per row group, lane i of a group limb i, which
// reads digit sums 2i and 2i + 1, brings their carries to 0/1 by two
// shuffles and takes the rest, the compares and the +-P corrections from
// ballots; a row of more than 32 limbs (the exact path on bases of 17
// primes and more: the key switch's 46 limbs at logn=14, 88 at logn=15,
// 147 at logn=16) takes the whole warp, 32 limbs a chunk, its limbs in NCH
// registers a lane, at most MAX_CHUNKS (192 limbs: every basis up to 103
// primes of 59 bits).  (The
// first design walked each row in global memory, digits kd words apart
// across a warp, and kept the limbs in a 1 KB local array, u64 r[128]:
// 8.5 us at 5.0x its byte bound.)
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include "mma.cuh"
#include "mont.cuh"
#include "rowwarp.cuh"

#define MAX_CHUNKS 6      // the lift's chunks of 32 limbs a row: at most 192 limbs

// decompose: a block takes DEC_ROWS coefficients (two a lane, 32 apart) of
// one slab against a tile of at most DEC_PRIMES primes (grid.y walks the
// tiles), warp w the primes w and w + DEC_WARPS of the tile
#define DEC_WARPS 8
#define DEC_ROWS 64
#define DEC_PRIMES 16
#define DEC_KC 64         // limbs of a row staged in shared memory at a time
#define DEC_GROUP 256     // limbs summed before a reduction: a group's sum < 2^40 p
#define DEC_BATCH 8       // staged words a thread has in flight
#define DEC_RL (DEC_ROWS / 32)          // rows a lane
#define DEC_PL (DEC_PRIMES / DEC_WARPS) // primes a warp

// digit_split, the digit product on the tensor cores: a block of DS_WARPS
// warps, each DS_WARP_M coefficients x DS_WARP_N byte columns (two m16 and
// eight n8 fragments), the depth in chunks of DS_DEPTH bytes, two stages
#define DS_WARPS 8
#define DS_WARP_M 32
#define DS_WARP_N 64
#define DS_DEPTH 128      // a chunk's depth: 128 / NB primes of NB bytes
#define DS_PAD 16         // bytes past a row's chunk in shared memory
#define DS_BLOCKS_AN_SM 2 // resident blocks an SM (registers and shared memory)
#define DS_OUT_PAD 4      // words past a row of a warp's staged digit sums

constexpr int DS_KS = DS_DEPTH + DS_PAD;                        // a row in shared memory
constexpr int DS_TILE = DS_WARPS * DS_WARP_M * DS_WARP_N;       // a block's bm x bn
// two stages of bm + bn <= 320 rows
constexpr int DS_SMEM = 2 * (DS_TILE / DS_WARP_N + DS_WARP_N) * DS_KS;
static_assert(DS_WARP_M == 32 && DS_WARP_N % 16 == 0, "a warp: two m16 fragments, n8 pairs");
static_assert(DS_TILE / DS_WARP_N == 256, "bm = 256 / wn: 2^(8 - log2 wn) rows");
// a warp's staged digit sums: 16 rows of its 32 (DS_WARP_N / 2), DS_OUT_W
// words apart; the warps' together fit in a stage at every wn
constexpr int DS_OUT_W = DS_WARP_N / 2 + DS_OUT_PAD;
static_assert(DS_WARPS * 16 * DS_OUT_W * 8 <= (128 + 128) * DS_KS, "the warps' sums fit a stage");

// decompose on the tensor cores: a tile of DM_ROWS rows against DM_COLS byte
// columns (the digit product's warps, two down and four across), a chunk of
// depth DS_DEPTH bytes = DM_CHUNK limbs, each thread staging DM_LOADS limbs
#define DM_ROWS 64
#define DM_OUT_PAD 8      // words past a row of a warp's staged column sums
constexpr int DM_COLS = DS_TILE / DM_ROWS;                       // 256
constexpr int DM_CHUNK = DS_DEPTH / 4;                            // 32 limbs
constexpr int DM_LOADS = DM_ROWS * DM_CHUNK / (DS_WARPS * 32);    // 8
constexpr int DM_OUT_W = DS_WARP_N + DM_OUT_PAD;
static_assert(DM_CHUNK == 32 && DM_ROWS == 8 * DM_LOADS, "lane = limb, warp + 8 u = row");
static_assert(DM_ROWS / DS_WARP_M * (DM_COLS / DS_WARP_N) == DS_WARPS, "the warps cover a tile");
static_assert(DM_OUT_W % 4 == 0, "a row's staged sums 16-byte aligned");
static_assert(DS_WARPS * 16 * DM_OUT_W * 4 <= (DM_ROWS + DM_COLS) * DS_KS,
              "the warps' sums fit a stage");

// c_i = 2^(32 i) R mod p (R = 2^64) of limb i, from the weights w_j = R^(j+1)
// mod p (row of one prime) and c1 = 2^32 R mod p: c_2j = w_j and
// c_2j+1 = mont_mul(w_j, c1) = R^(j+1) 2^32.
__device__ __forceinline__ u64 limb_const(const u64 *w, int i, u64 c1, u64 p, u64 pinv) {
    const u64 wj = __ldg(w + i / 2);
    return i & 1 ? mont_mul(wj, c1, p, pinv) : wj;
}

// c1 = 2^32 R mod p from the weights of one prime: 2^32 mod p =
// mont_reduce(w0 2^32), times w1 = R^2; with one weight, w0 doubled 32 times.
__device__ __forceinline__ u64 c1_of(const u64 *w, int J, u64 p, u64 pinv) {
    const u64 w0 = __ldg(w);
    if (J > 1) return mont_mul(mont_reduce(w0 >> 32, w0 << 32, p, pinv), __ldg(w + 1), p, pinv);
    u64 c1 = w0;
    for (int b = 0; b < 32; ++b) c1 = addmod(c1, c1, p);
    return c1;
}

// 2^src_bits mod p = (c_f 2^e) R^-1, src_bits = 32 f + e, f < K: what a
// negative row of a two's-complement input of src_bits width subtracts
__device__ __forceinline__ u64 pow2_src(const u64 *w, int J, int K, int src_bits, u64 p,
                                        u64 pinv) {
    const int f = src_bits / 32 < K ? src_bits / 32 : K - 1;
    const int sh = src_bits - 32 * f;
    const u64 c = limb_const(w, f, c1_of(w, J, p, pinv), p, pinv);
    return mont_reduce(sh ? c >> (64 - sh) : 0, c << sh, p, pinv);
}

// a[0..3] (a 128-bit sum, 32-bit words) += x * c, c = c.y:c.x (NH = 2) or
// c.x (NH = 1): the 32 x 64-bit product by lo and hi 32-bit multiplies
// (IMAD, IMAD.HI) and the carries through the words (IADD3.X).
template <int NH>
__device__ __forceinline__ void mad_128(u32 (&a)[4], u32 x, const uint2 &c) {
    if (NH == 1) {
        asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
            "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
            "addc.u32 %2, %2, 0;"
            : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]) : "r"(x), "r"(c.x));
    } else {
        asm("mad.lo.cc.u32 %0, %4, %5, %0;\n\t"
            "madc.hi.cc.u32 %1, %4, %5, %1;\n\t"
            "madc.hi.cc.u32 %2, %4, %6, %2;\n\t"
            "addc.u32 %3, %3, 0;\n\t"
            "mad.lo.cc.u32 %1, %4, %6, %1;\n\t"
            "addc.cc.u32 %2, %2, 0;\n\t"
            "addc.u32 %3, %3, 0;"
            : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]) : "r"(x), "r"(c.x), "r"(c.y));
    }
}

struct DecArgs {
    u64 *out;
    i64 S, n, ss, sn;
    int K, dim, J, src_bits;
    const u64 *a, *w;
    PerPrime P, V;
    FastDiv kc_full, kc_last;   // a chunk's limbs: min(K, DEC_KC), and the last chunk's
};

// Stage rows r0 .. r0 + rows - 1, limbs c0 .. c0 + kc - 1 of one slab into
// shared memory as u32 (DEC_KC + 1 words a row: the lanes read rows 65 words
// apart, without bank conflicts), a negative row's limbs masked to
// src_bits.  The block's rows are neighbouring words of a row-contiguous
// operand: thread t loads words t, t + 256, ..., DEC_BATCH loads in flight
// before the first store.
__device__ __forceinline__ void dec_stage(const DecArgs &g, const u64 *slab, i64 r0, int rows,
                                          int c0, const FastDiv &kc, const bool *neg,
                                          u32 *limbs) {
    const int words = rows * (int)kc.d, full = g.src_bits / 32, rem = g.src_bits % 32;
    for (int base = threadIdx.x; base < words; base += DEC_BATCH * DEC_WARPS * 32) {
        u64 x[DEC_BATCH];
#pragma unroll
        for (int u = 0; u < DEC_BATCH; ++u) {
            const int idx = base + u * DEC_WARPS * 32;
            if (idx < words) {
                const int rr = kc.div(idx);
                x[u] = __ldg(slab + (r0 + rr) * g.sn + c0 + idx - rr * (int)kc.d);
            }
        }
#pragma unroll
        for (int u = 0; u < DEC_BATCH; ++u) {
            const int idx = base + u * DEC_WARPS * 32;
            if (idx < words) {
                const int rr = kc.div(idx), i = idx - rr * (int)kc.d, li = c0 + i;
                u64 v = x[u];
                if (g.src_bits > 0 && neg[rr])
                    v = li > full || (li == full && rem == 0) ? 0
                        : li == full ? v & ((1ull << rem) - 1) : v;
                limbs[rr * (DEC_KC + 1) + i] = (u32)v;
            }
        }
    }
}

// The constants of limbs c0 .. c0 + kc - 1 for the tile's primes as uint2
// halves (a broadcast load), and each prime's p and pinv: DEC_CST entries a
// thread at most, their loads in flight together.
#define DEC_CST (DEC_PRIMES * DEC_KC / (DEC_WARPS * 32))
__device__ __forceinline__ void dec_consts(const DecArgs &g, int d0, int np, int c0,
                                           const FastDiv &kc, uint2 *cst, u64 *tp) {
    const int entries = np * (int)kc.d;
#pragma unroll
    for (int u = 0; u < DEC_CST; ++u) {
        const int idx = threadIdx.x + u * DEC_WARPS * 32;
        if (idx < entries) {
            const int dl = kc.div(idx), i = idx - dl * (int)kc.d, d = d0 + dl;
            const u64 p = g.P.at(d), pinv = g.V.at(d), *w = g.w + (i64)d * g.J;
            const u64 c = limb_const(w, c0 + i, c1_of(w, g.J, p, pinv), p, pinv);
            cst[dl * DEC_KC + i] = make_uint2((u32)c, (u32)(c >> 32));
            if (i == 0) {
                tp[2 * dl] = p;
                tp[2 * dl + 1] = pinv;
            }
        }
    }
}

// The sums of a thread's rows (lane + 32 j) against its primes (warp + e
// DEC_WARPS) over the staged chunk, NH halves a constant.
template <int NH>
__device__ __forceinline__ void dec_accumulate(u32 (&A)[DEC_RL][DEC_PL][4], const u32 *limbs,
                                               const uint2 *cst, int kcn) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 2
    for (int i = 0; i < kcn; ++i) {
        u32 x[DEC_RL];
#pragma unroll
        for (int j = 0; j < DEC_RL; ++j) x[j] = limbs[(lane + 32 * j) * (DEC_KC + 1) + i];
#pragma unroll
        for (int e = 0; e < DEC_PL; ++e) {
            const uint2 c = cst[(warp + e * DEC_WARPS) * DEC_KC + i];
#pragma unroll
            for (int j = 0; j < DEC_RL; ++j) mad_128<NH>(A[j][e], x[j], c);
        }
    }
}

// limbs (u32 values in int64) [S, n, K] with strides (ss, sn, 1) -> residues
// [S, dim, n]: residue d of a row is sum_i limb_i c_i R^-1 mod p_d, the sum
// of a group of at most DEC_GROUP limbs below 2^40 p, so that its high
// 64-bit word is below p, as mont_reduce needs, for primes of any width
// (the logp=9 chain's 10 bits too); each result in [0, p).  src_bits > 0:
// the input is two's complement of that width; a negative value
// decomposes as p - (|value| mod p) (0 stays 0), which is
// (value mod 2^src_bits) - 2^src_bits mod p.
// Three blocks an SM: 78 registers a thread, no spill (the build gate).
__global__ void __launch_bounds__(DEC_WARPS * 32, 3) rns_decompose_kernel(DecArgs g) {
    __shared__ u32 limbs[DEC_ROWS * (DEC_KC + 1)];
    __shared__ uint2 cst[DEC_PRIMES * DEC_KC];
    __shared__ u64 tp[2 * DEC_PRIMES];      // each prime's p and pinv
    __shared__ bool neg[DEC_ROWS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const i64 r0 = (i64)blockIdx.x * DEC_ROWS;
    const int d0 = blockIdx.y * DEC_PRIMES;
    const int np = g.dim - d0 < DEC_PRIMES ? g.dim - d0 : DEC_PRIMES;
    const int rows = (int)(g.n - r0 < DEC_ROWS ? g.n - r0 : DEC_ROWS);
    // the halves a constant takes: two where a prime of the tile has 33 bits or more
    const u64 pl = lane < np ? g.P.at(d0 + lane) : 0;
    const bool wide = __any_sync(~0u, (pl >> 32) != 0);
    bool ready = false;                     // the constants of a one-chunk row, built
    for (i64 s = blockIdx.z; s < g.S; s += gridDim.z) {
        const u64 *slab = g.a + s * g.ss;
        if (g.src_bits > 0) {
            // the sign of each row, read once: a negative row's limbs are
            // taken mod 2^src_bits and 2^src_bits is subtracted at the end
            __syncthreads();                // the previous slab's readers are done
            if (tid < rows) {
                const int hb = g.src_bits - 1;
                neg[tid] = (__ldg(slab + (r0 + tid) * g.sn + hb / 32) >> (hb % 32)) & 1;
            }
            __syncthreads();
        }
        u32 A[DEC_RL][DEC_PL][4] = {};
        u64 r[DEC_RL][DEC_PL] = {};
        for (int c0 = 0; c0 < g.K; c0 += DEC_KC) {
            const bool last = c0 + DEC_KC >= g.K;
            const FastDiv kc = last ? g.kc_last : g.kc_full;
            dec_stage(g, slab, r0, rows, c0, kc, neg, limbs);
            if (!ready || g.K > DEC_KC) dec_consts(g, d0, np, c0, kc, cst, tp);
            __syncthreads();
            if (wide) dec_accumulate<2>(A, limbs, cst, (int)kc.d);
            else dec_accumulate<1>(A, limbs, cst, (int)kc.d);
            if (last || (c0 + DEC_KC) % DEC_GROUP == 0) {
#pragma unroll
                for (int e = 0; e < DEC_PL; ++e) {
                    const int dl = warp + e * DEC_WARPS < np ? warp + e * DEC_WARPS : 0;
                    const u64 p = tp[2 * dl], pinv = tp[2 * dl + 1];
#pragma unroll
                    for (int j = 0; j < DEC_RL; ++j) {
                        u32 *a = A[j][e];
                        const u64 lo = ((u64)a[1] << 32) | a[0], hi = ((u64)a[3] << 32) | a[2];
                        r[j][e] = addmod(r[j][e], mont_reduce(hi, lo, p, pinv), p);
                        a[0] = a[1] = a[2] = a[3] = 0;
                    }
                }
            }
            __syncthreads();                // the chunk's readers are done
        }
        ready = true;
#pragma unroll
        for (int e = 0; e < DEC_PL; ++e) {
            const int dl = warp + e * DEC_WARPS;
            if (dl >= np) continue;
            const u64 p = tp[2 * dl];
            const u64 tsrc = g.src_bits > 0 ? pow2_src(g.w + (i64)(d0 + dl) * g.J, g.J, g.K,
                                                       g.src_bits, p, tp[2 * dl + 1])
                                            : 0;
            u64 *o = g.out + (s * g.dim + d0 + dl) * g.n + r0;
#pragma unroll
            for (int j = 0; j < DEC_RL; ++j) {
                const int rr = lane + 32 * j;
                if (rr >= rows) continue;
                o[rr] = g.src_bits > 0 && neg[rr] ? submod(r[j][e], tsrc, p) : r[j][e];
            }
        }
    }
}

// The products of one staged chunk: a warp's two m16 fragments of A (rows
// 16 apart from its lane's ldmatrix address a_lane) against its `live` n8
// tiles of B (from b_lane), `depth` bytes walked 32 at a time.  Per 32 bytes
// the warp loads its two A fragments and its live B fragments once and
// issues up to 2 FN products.
template <int FN>
__device__ __forceinline__ void mma_chunk(int (&acc)[2][FN][4], u32 base, u32 a_lane, u32 b_lane,
                                          int depth, int live) {
    for (int kk = 0; kk < depth; kk += 32) {
        u32 a0[4], a1[4];
        ldsm_x4(a0, base + a_lane + kk);
        ldsm_x4(a1, base + a_lane + 16 * DS_KS + kk);
#pragma unroll
        for (int j = 0; j < FN; j += 2) {
            if (j >= live) break;
            u32 b[4];
            ldsm_x4(b, base + b_lane + 8 * j * DS_KS + kk);
            mma_u8(acc[0][j], a0, b[0], b[1]);
            mma_u8(acc[1][j], a1, b[0], b[1]);
            if (j + 1 < live) {
                mma_u8(acc[0][j + 1], a0, b[2], b[3]);
                mma_u8(acc[1][j + 1], a1, b[2], b[3]);
            }
        }
    }
}

// residues y [S, dim, n] (a view) -> the digit sums of S = sum_d y_d phat_d,
// int64 [S, n, kd], and af f64 [S, n] = sum_d y_d / p_d.  With scale, y_d is
// first replaced by mont_mul(y_d, scale_d) (the phat^-1 multiply).  The
// product on the tensor cores: a residue below 2^(8 NB) is its own NB
// little-endian bytes (NB = 8, or 4 where the primes fit 32 bits), so the A
// operand is the residues themselves, row = coefficient, depth (d, t) =
// byte t of y_d at d NB + t; B is the plan's table (u8 [2 ds, tdepth], row
// c, depth d NB + t: byte c - t of phat_d), and mma.sync m16n8k32 u8 x u8 ->
// s32 sums byte column c of S,
//   B_c = sum_{d, t} y_d[t] phat_d[c - t] <= NB dim 255^2 < 2^31 (dim <= 4128 at NB = 8),
// exact.  The epilogue combines byte columns 2j and 2j + 1 into the 16-bit
// digit sum S16_j = B_2j + 256 B_2j+1 < 2^40, so that sum_j S16_j 2^(16 j)
// = S mod 2^(16 kd) (the table's columns stop at 2 kd: the lift works mod
// 2^(32 k_out), 32 k_out <= 16 kd).
//
// A tile is bm coefficients of one slab against bn byte columns, bm bn =
// DS_TILE: the warps' DS_WARP_M x DS_WARP_N tiles, wn of them across the
// columns (wn = 1, 2 or 4: the fewest that cover 2 kd columns, bn = 64 wn,
// bm = 256 / wn; past 256 columns a second tile of columns).  The blocks are
// persistent, DS_BLOCKS_AN_SM an SM, each walking the tiles gridDim.x apart
// (columns fastest, then coefficients, then slabs) in chunks of DS_DEPTH
// bytes of depth (128 / NB primes), two stages in shared memory: while the
// warps multiply one chunk, cp.async brings the next, the next tile's
// first after a tile's last, so that the loads run on through the
// epilogue.  The residues come NB bytes a copy straight into their rows
// (16 / NB lanes fill a row's 16 bytes, coalesced along n; zeros past n and
// dim), the table's rows of the tile's columns 16 bytes a copy.  Then each
// thread reads its row's residues of the chunk back, scales them in place
// and adds them into af.  Rows are DS_KS bytes apart (16 bytes past the
// chunk), so that ldmatrix's rows are free of bank conflicts; an
// ldmatrix.x4 of A [16 rows x 32 bytes] is an A fragment, of B [16 columns
// x 32 bytes] the B fragments of two n8 tiles.  Per 32 bytes of depth a
// warp loads its two A fragments and its live B fragments once and issues
// up to 16 products; the depth past NB dim is not walked.  The digit sums
// go through the stage just worked, each warp its own 16 rows at a time
// (rows DS_OUT_PAD words longer than its 32 sums, free of bank conflicts,
// no block-wide barrier), to 32 neighbouring words of a row in device
// memory (from the registers, a store would be 8 rows x 4 words: two
// sectors for each 32 bytes where a row's words are not 32-byte aligned).
// af: each thread sums its primes in chunk order, then thread r of
// the block the threads of its row in order (a fixed order, not the plain
// version's).
// One tile of the digit product: slab s, coefficients k0 .. k0 + rows - 1,
// byte columns c0 .. c0 + cols - 1, of which a warp's live n8 tiles.
struct DsTile {
    const u64 *ys;                              // the tile's first residue
    i64 s, k0;
    int rows, c0, cols, live;
};

template <int NB>
__global__ void __launch_bounds__(DS_WARPS * 32, 2)
rns_digit_split_kernel_mma(i64 *__restrict__ sums, double *__restrict__ af, i64 S, int dim,
                           i64 n, int kd, int lwn, View y, PerPrime scale, PerPrime P,
                           PerPrime V, const double *__restrict__ inv_p, i64 ipd,
                           const u8 *__restrict__ table, int tdepth) {
    constexpr int LE = NB == 8 ? 1 : 2;         // 2^LE residues a 16-byte run of a row
    constexpr int DCP = DS_DEPTH / NB;          // primes a chunk
    constexpr int FN = DS_WARP_N / 8;           // a warp's n8 tiles
    extern __shared__ __align__(16) u8 smem[];
    __shared__ double part[DS_WARPS * 32];
    const int lbm = 8 - lwn, bm = 1 << lbm, bn = DS_WARP_N << lwn;   // bm bn = DS_TILE
    const u32 stage = (bm + bn) * DS_KS;        // a stage: A [bm][DS_KS], B [bn][DS_KS]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wr = (warp >> lwn) * DS_WARP_M, wc = (warp & ((1 << lwn) - 1)) * DS_WARP_N;
    const int r = tid & (bm - 1), u = tid >> lbm, qs = DS_WARPS * 32 >> lbm;  // af: row r
    const int chunks = (NB * dim + DS_DEPTH - 1) / DS_DEPTH;
    const int tiles_c = (2 * kd + bn - 1) >> (6 + lwn);
    const i64 tiles_k = (n + bm - 1) >> lbm, items = S * tiles_k * tiles_c;
    const u32 s0 = smem_addr(smem);
    const u32 a_lane = (wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * DS_KS + 16 * (lane >> 4);
    const u32 b_lane = bm * DS_KS + (wc + (lane & 7) + 8 * (lane >> 4)) * DS_KS +
                       16 * ((lane >> 3) & 1);
    // item -> tile: column blocks fastest, then coefficients, then slabs
    auto tile_of = [&](i64 item) {
        DsTile T;
        const i64 q = item / tiles_c;
        T.c0 = (int)(item - q * tiles_c) * bn;
        T.s = q / tiles_k;
        T.k0 = (q - T.s * tiles_k) << lbm;
        T.rows = n - T.k0 < bm ? (int)(n - T.k0) : bm;
        T.cols = 2 * kd - T.c0 < bn ? 2 * kd - T.c0 : bn;
        T.live = T.cols - wc <= 0 ? 0 : T.cols - wc >= DS_WARP_N ? FN : (T.cols - wc + 7) / 8;
        T.ys = y.p + T.s * y.sa + T.k0 * y.sk;
        return T;
    };
    // chunk ch of tile T into stage st: copy idx = (pg bm + row) 2^LE + e takes
    // residue (row, d0 + pg 2^LE + e), 2^LE lanes a row's 16 bytes
    auto fetch = [&](const DsTile &T, int ch, int st) {
        const u32 base = s0 + st * stage;
        const int d0 = ch * DCP;
        for (int idx = tid; idx < bm * DCP; idx += DS_WARPS * 32) {
            const int e = idx & ((1 << LE) - 1), rest = idx >> LE;
            const int row = rest & (bm - 1), d = ((rest >> lbm) << LE) + e;
            const bool in = d0 + d < dim && row < T.rows;
            cp_async_zfill<NB>(base + row * DS_KS + NB * d,
                               in ? T.ys + (i64)(d0 + d) * y.sd + row * y.sk : y.p, in);
        }
        for (int i = tid; i < T.cols * (DS_DEPTH / 16); i += DS_WARPS * 32) {
            const int c = i >> 3, o = i & 7;
            cp_async16(base + (bm + c) * DS_KS + 16 * o,
                       table + (i64)(T.c0 + c) * tdepth + ch * DS_DEPTH + 16 * o);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    i64 item = blockIdx.x;
    if (item >= items) return;
    DsTile T = tile_of(item);
    fetch(T, 0, 0);
    int acc[2][FN][4] = {};
    double ap = 0.0;
    for (int ch = 0, st = 0;; st ^= 1) {
        // the next step (the next chunk, or the next tile's first) lands
        // while this one is worked
        const bool last = ch + 1 == chunks;
        const i64 next = last ? item + gridDim.x : item;
        const bool more = next < items;
        const DsTile N = last && more ? tile_of(next) : T;
        if (more) {
            fetch(N, last ? 0 : ch + 1, st ^ 1);
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        __syncthreads();
        u8 *as = smem + st * stage;
        const int d0 = ch * DCP;
        if (r < T.rows) {
            for (int d = u; d < DCP && d0 + d < dim; d += qs) {
                u8 *w = as + r * DS_KS + NB * d;
                u64 x = NB == 8 ? *(u64 *)w : *(u32 *)w;
                if (scale.p) {
                    x = mont_mul(x, scale.at(d0 + d), P.at(d0 + d), V.at(d0 + d));
                    if constexpr (NB == 8) *(u64 *)w = x; else *(u32 *)w = (u32)x;
                }
                ap += (double)(i64)x * __ldg(inv_p + (d0 + d) * ipd);
            }
        }
        if (scale.p) __syncthreads();
        const int depth = NB * dim - d0 * NB < DS_DEPTH ? NB * dim - d0 * NB : DS_DEPTH;
        if (T.live > 0) mma_chunk(acc, s0 + st * stage, a_lane, b_lane, depth, T.live);
        __syncthreads();                        // the stage's readers are done
        if (last) {
            // the epilogue: byte columns 2j and 2j + 1 (this lane's 2t, 2t + 1
            // of each n8 tile) into digit sum j, rows g and g + 8 of each
            // fragment; a warp stages each of its two fragments' 16 rows x 32
            // sums in its own part of the stage just worked (rows DS_OUT_PAD
            // words longer), then writes them a row at a time, 32 neighbouring
            // words
            i64 *out = (i64 *)(smem + st * stage) + warp * 16 * DS_OUT_W;
            const int wcols = T.cols / 2 - wc / 2 < 4 * T.live ? T.cols / 2 - wc / 2 : 4 * T.live;
#pragma unroll
            for (int f = 0; f < 2; ++f) {
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int j = 0; j < FN; ++j) {
                        if (j < T.live)
                            out[(g + 8 * h) * DS_OUT_W + 4 * j + t] =
                                (i64)(u32)acc[f][j][2 * h] + ((i64)(u32)acc[f][j][2 * h + 1] << 8);
                        acc[f][j][2 * h] = acc[f][j][2 * h + 1] = 0;
                    }
                __syncwarp();
                i64 *o = sums + (T.s * n + T.k0 + wr + 16 * f) * kd + T.c0 / 2 + wc / 2 + lane;
                for (int row = 0; row < 16 && wr + 16 * f + row < T.rows; ++row)
                    if (lane < wcols) o[(i64)row * kd] = out[row * DS_OUT_W + lane];
                __syncwarp();
            }
            part[tid] = ap;
            ap = 0.0;
            __syncthreads();
            if (T.c0 == 0 && tid < T.rows) {
                double a = part[tid];
                for (int v = 1; v < qs; ++v) a += part[tid + v * bm];
                af[T.s * n + T.k0 + tid] = a;
            }
        }
        if (!more) break;
        ch = last ? 0 : ch + 1;
        item = next;
        T = N;
    }
}

// decompose on the tensor cores, for rows of many limbs (the wrapper takes
// this route for K >= rns_cuda.MMA_MIN_LIMBS): limbs [S, n, K] -> residues
// [S, dim, n], the same function as rns_decompose_kernel.  A row's K limbs
// are its 4K little-endian bytes x_j, and residue d is
//   sum_j x_j c_dj R^-1 mod p_d,   c_dj = 2^(8 j) R mod p_d,
// so the products are u8 ones: A the rows' bytes (depth j), B the table
// (u8 [NB dim, tdepth], rns_cuda.decompose_table: row NB d + k, depth j
// holds byte k of c_dj; NB = 8, or 4 where the primes fit 32 bits), and
// mma.sync m16n8k32 u8 x u8 -> s32 sums byte column k of prime d,
//   s_dk = sum_j x_j c_dj[k] <= 4K 255^2 < 2^31 (K <= 8256),
// exact.  The epilogue folds a prime's NB columns, V = sum_k s_dk 2^(8 k) =
// sum_j x_j c_dj < 4K 2^8 p, whose high 64-bit word is below p (4K 2^8 <
// 2^64), so one mont_reduce(hi, lo) gives the residue; a negative row (src_bits
// > 0) subtracts 2^src_bits mod p, its limbs masked to src_bits as they land,
// as rns_decompose_kernel does.  The work an output: 2 NB u8 products a limb
// on the tensor cores, and a fold and one reduction whatever K is.
//
// The loop is the digit product's: persistent blocks, DS_BLOCKS_AN_SM an
// SM, each walking the tiles (DM_ROWS rows of a slab x DM_COLS byte
// columns; columns fastest, so that a row tile's limbs are read from L2 by
// the blocks of its other column tiles) gridDim.x apart, the depth in
// chunks of DS_DEPTH bytes (DM_CHUNK limbs), two stages in shared memory.
// Both operands come by cp.async, issued a step ahead: the table's rows 16
// bytes a copy; the limbs are int64 words whose low halves are the bytes, so
// lane l of warp w copies the low 4 bytes of limb 32 ch + l of rows w + 8 u
// (a warp a row's 256 bytes) to their packed place in the stage, zeros past
// the row's limbs or the tile's rows (the stage holds no stale byte), and
// masks its own words of a negative row once they have landed.  Epilogue:
// each warp stages its two fragments' s32 sums 16 rows at a time in its part
// of the stage just worked (rows DM_OUT_PAD words longer), then lane (r, q)
// of it folds and reduces row r's primes q, q + 2, ..., and writes them, 16
// neighbouring words of a prime's row of residues a store.
struct DmTile {
    i64 s, k0;
    int rows, c0, cols, live;
};

template <int NB>
__global__ void __launch_bounds__(DS_WARPS * 32, DS_BLOCKS_AN_SM)
rns_decompose_kernel_mma(u64 *__restrict__ out, const u64 *__restrict__ a, i64 S, i64 n, int K,
                         i64 ss, i64 sn, int dim, int J, const u64 *__restrict__ w, PerPrime P,
                         PerPrime V, int src_bits, const u8 *__restrict__ table, int tdepth) {
    constexpr int FN = DS_WARP_N / 8;           // a warp's n8 tiles
    constexpr int PW = DS_WARP_N / NB;          // a warp's primes
    extern __shared__ __align__(16) u8 smem[];
    __shared__ u64 wp[DS_WARPS][PW][3];         // a warp's primes: p, pinv, 2^src_bits mod p
    const u32 stage = (DM_ROWS + DM_COLS) * DS_KS;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wr = (warp >> 2) * DS_WARP_M, wc = (warp & 3) * DS_WARP_N;
    const int chunks = (4 * K + DS_DEPTH - 1) / DS_DEPTH;
    const int tiles_c = (NB * dim + DM_COLS - 1) / DM_COLS;
    const i64 tiles_k = (n + DM_ROWS - 1) / DM_ROWS, items = S * tiles_k * tiles_c;
    const int full = src_bits / 32, rem = src_bits % 32, hb = src_bits - 1;
    const u32 s0 = smem_addr(smem);
    const u32 a_lane = (wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * DS_KS + 16 * (lane >> 4);
    const u32 b_lane = (DM_ROWS + wc + (lane & 7) + 8 * (lane >> 4)) * DS_KS +
                       16 * ((lane >> 3) & 1);
    // item -> tile: column blocks fastest, then rows, then slabs
    auto tile_of = [&](i64 item) {
        DmTile T;
        const i64 q = item / tiles_c;
        T.c0 = (int)(item - q * tiles_c) * DM_COLS;
        T.s = q / tiles_k;
        T.k0 = (q - T.s * tiles_k) * DM_ROWS;
        T.rows = n - T.k0 < DM_ROWS ? (int)(n - T.k0) : DM_ROWS;
        T.cols = NB * dim - T.c0 < DM_COLS ? NB * dim - T.c0 : DM_COLS;
        T.live = T.cols - wc <= 0 ? 0 : T.cols - wc >= DS_WARP_N ? FN : (T.cols - wc + 7) / 8;
        return T;
    };
    auto row_of = [&](const DmTile &T, int r) { return a + T.s * ss + (T.k0 + r) * sn; };
    auto negative = [&](const DmTile &T, int r) {
        return src_bits > 0 && ((__ldg((const u32 *)(row_of(T, r) + hb / 32)) >> (hb % 32)) & 1);
    };
    // chunk ch of tile T into stage st: this thread's limbs (the low 32-bit
    // half of each int64 word, 4 bytes a copy; zeros past the row's limbs
    // and the tile's rows) and the table's rows of the tile's columns
    auto fetch = [&](const DmTile &T, int ch, int st) {
        const u32 base = s0 + st * stage;
        const int li = DM_CHUNK * ch + lane;
#pragma unroll
        for (int u = 0; u < DM_LOADS; ++u) {
            const int r = warp + 8 * u;
            const bool in = r < T.rows && li < K;
            cp_async_zfill<4>(base + r * DS_KS + 4 * lane, in ? row_of(T, r) + li : a, in);
        }
        for (int i = tid; i < T.cols * (DS_DEPTH / 16); i += DS_WARPS * 32) {
            const int c = i >> 3, o = i & 7;
            cp_async16(base + (DM_ROWS + c) * DS_KS + 16 * o,
                       table + (i64)(T.c0 + c) * tdepth + ch * DS_DEPTH + 16 * o);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    // once this thread's copies of chunk ch have landed: a negative row's
    // limbs at and past the sign's word masked to src_bits
    auto mask = [&](const DmTile &T, int ch, int st) {
        const int li = DM_CHUNK * ch + lane;
        if (src_bits <= 0 || li < full || li >= K) return;
        u32 *as = (u32 *)(smem + st * stage);
#pragma unroll
        for (int u = 0; u < DM_LOADS; ++u) {
            const int r = warp + 8 * u;
            if (r < T.rows && negative(T, r)) {
                u32 &v = as[r * (DS_KS / 4) + lane];
                v = li > full || rem == 0 ? 0 : v & ((1u << rem) - 1);
            }
        }
    };
    // the epilogue of tile T, its sums in stage st; the warp's primes'
    // constants made where its tile of columns changes
    int wp_c0 = -1;
    auto epilogue = [&](const DmTile &T, int (&acc)[2][FN][4], int st) {
        const int e0 = (T.c0 + wc) / NB;        // the warp's first prime
        const int np = T.cols - wc <= 0              ? 0
                       : T.cols - wc < DS_WARP_N ? (T.cols - wc) / NB
                                                 : PW;  // the warp's live primes
        if (T.c0 != wp_c0 && lane < np) {
            const u64 p = P.at(e0 + lane), pinv = V.at(e0 + lane);
            wp[warp][lane][0] = p;
            wp[warp][lane][1] = pinv;
            wp[warp][lane][2] = src_bits > 0 ? pow2_src(w + (i64)(e0 + lane) * J, J, K, src_bits,
                                                        p, pinv)
                                             : 0;
        }
        wp_c0 = T.c0;
        u32 *sm = (u32 *)(smem + st * stage) + warp * 16 * DM_OUT_W;
        const int r = lane & 15;
#pragma unroll
        for (int f = 0; f < 2; ++f) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int j = 0; j < FN; ++j) {
                    if (j < T.live)
                        *(uint2 *)(sm + (g + 8 * h) * DM_OUT_W + 8 * j + 2 * t) =
                            make_uint2((u32)acc[f][j][2 * h], (u32)acc[f][j][2 * h + 1]);
                    acc[f][j][2 * h] = acc[f][j][2 * h + 1] = 0;
                }
            __syncwarp();
            const int row = wr + 16 * f + r;
            if (row < T.rows) {
                const bool neg = negative(T, row);
                u64 *o = out + (T.s * dim + e0) * n + T.k0 + row;
                for (int e = lane >> 4; e < np; e += 2) {
                    const u32 *cs = sm + r * DM_OUT_W + NB * e;
                    const uint4 c4 = *(const uint4 *)cs;
                    // a_i = s_2i + 2^8 s_2i+1 < 2^40; V = sum_i a_i 2^(16 i) as hi:lo
                    const u64 a0 = c4.x + ((u64)c4.y << 8), a1 = c4.z + ((u64)c4.w << 8);
                    u64 lo = a0 + (a1 << 16), hi = 0;
                    if constexpr (NB == 8) {
                        const uint4 d4 = *(const uint4 *)(cs + 4);
                        const u64 a2 = d4.x + ((u64)d4.y << 8), a3 = d4.z + ((u64)d4.w << 8);
                        hi = (a1 >> 48) + (lo < (a1 << 16));
                        u64 x = a2 << 32;
                        lo += x;
                        hi += (a2 >> 32) + (lo < x);
                        x = a3 << 48;
                        lo += x;
                        hi += (a3 >> 16) + (lo < x);
                    }
                    const u64 *pe = wp[warp][e];
                    const u64 res = mont_reduce(hi, lo, pe[0], pe[1]);
                    o[(i64)e * n] = neg ? submod(res, pe[2], pe[0]) : res;
                }
            }
            __syncwarp();
        }
    };
    i64 item = blockIdx.x;
    if (item >= items) return;
    DmTile T = tile_of(item);
    fetch(T, 0, 0);
    int acc[2][FN][4] = {};
    for (int ch = 0, st = 0;; st ^= 1) {
        // the next step (the next chunk, or the next tile's first) lands
        // while this one is worked
        const bool last = ch + 1 == chunks;
        const i64 next = last ? item + gridDim.x : item;
        const bool more = next < items;
        const DmTile N = last && more ? tile_of(next) : T;
        const int nch = last ? 0 : ch + 1;
        if (more) {
            fetch(N, nch, st ^ 1);
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        mask(T, ch, st);
        __syncthreads();
        const int depth = 4 * K - ch * DS_DEPTH < DS_DEPTH ? 4 * K - ch * DS_DEPTH : DS_DEPTH;
        if (T.live > 0) mma_chunk(acc, s0 + st * stage, a_lane, b_lane, depth, T.live);
        __syncthreads();                        // the stage's readers are done
        if (last) {
            epilogue(T, acc, st);
            __syncthreads();                    // before the stage takes the step after next
        }
        if (!more) break;
        ch = nch;
        item = next;
        T = N;
    }
}

// The lift's rows a lane at nch chunks of 32 limbs (rns_lift_kernel<NCH>).
__host__ __device__ constexpr int lift_rows_a_lane(int nch) {
    return nch < WARP_GROUPS ? WARP_GROUPS / nch : 1;
}

// x >= y over a row of NCH chunks, y a row of constant limbs, from the top
// chunk down.  Every lane calls it.
template <int NCH>
__device__ __forceinline__ bool row_geq(const LaneGroups &lg, const bool (&limb)[NCH],
                                        const u64 (&x)[NCH], const u64 (&y)[NCH]) {
    bool ge = true, done = false;
#pragma unroll
    for (int c = NCH - 1; c >= 0; --c) lane_geq(lg, limb[c], x[c], y[c], ge, done);
    return ge;
}

// x + P (add) or x - P over a row of NCH chunks where `on`, the carry or
// borrow passed chunk to chunk.  Every lane calls it.
template <int NCH>
__device__ __forceinline__ void row_correct(const LaneGroups &lg, const bool (&limb)[NCH],
                                            u64 (&x)[NCH], const u64 (&P)[NCH], bool on,
                                            bool add) {
    u64 carry = 0;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        const u64 y = add ? lane_add(lg, limb[c], x[c], P[c], carry)
                          : lane_sub(lg, limb[c], x[c], P[c], carry);
        x[c] = on ? y : x[c];
    }
}

// int64 digit sums [R, kd] (contiguous) and af [R] -> limbs [R, k_out]
// (exact: k_out = ks).  alpha = clamp(floor(af), 0, dim); the digits of
// S + alpha (2^(16 ds) - P) are carried into limbs; then the fast path
// subtracts P where af - alpha > 1/2, or the exact path corrects alpha by
// one either way and (center) maps [P/2, P) to negative values.  A warp per
// row group (rowwarp.cuh, LaneGroups): lane i of a group limb 32 c + i of
// its row in chunk c < NCH (NCH = 1: rows of at most 32 limbs, G groups a
// warp), which reads digit sums 2 (32 c + i) and 2 (32 c + i) + 1
// (coalesced: a group's digits are consecutive words of its row); the
// digits carried into limbs by lane_digits, the compares and the +-P
// corrections by ballots, chunk after chunk, the row's NCH limbs a lane and
// the constant limbs and digits in registers.  WARP_GROUPS / NCH rows a
// lane, one from four chunks on (four at two chunks kept a stack frame); at
// five and six chunks (129-192 limbs) a lane holds its one row's 2 NCH
// digit sums, 5 NCH constant words and NCH limbs in u64 registers.
template <int NCH>
__global__ void __launch_bounds__(ROWWARP_THREADS)
rns_lift_kernel(u64 *out, i64 R, int kd, int kuse, const i64 *sd, const double *af, double dimf,
                const i64 *negP16, int k_out, int exact, int center, const i64 *Pl,
                const i64 *Phalf, const i64 *MminusP) {
    constexpr int RL = lift_rows_a_lane(NCH);
    const LaneGroups lg(k_out);
    bool lane_limb[NCH];
    u64 n0[NCH], n1[NCH], P[NCH], Ph[NCH], MmP[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
        const int li = 32 * c + lg.i, j0 = 2 * li, j1 = j0 + 1;
        const bool l = lane_limb[c] = lg.grp < lg.G && li < k_out;
        n0[c] = l && j0 < kuse ? (u64)__ldg(negP16 + j0) : 0;
        n1[c] = l && j1 < kuse ? (u64)__ldg(negP16 + j1) : 0;
        P[c] = l ? (u64)__ldg(Pl + li) : 0;
        Ph[c] = l && exact ? (u64)__ldg(Phalf + li) : 0;
        MmP[c] = l && exact ? (u64)__ldg(MminusP + li) : 0;
    }
    const i64 warp = (i64)blockIdx.x * (ROWWARP_THREADS / 32) + (threadIdx.x >> 5);
    const i64 row0 = warp * (RL * lg.G) + lg.grp;
    u64 s0[RL][NCH], s1[RL][NCH];
    double a[RL];
#pragma unroll
    for (int u = 0; u < RL; ++u) {
        const i64 row = row0 + u * lg.G;
        const bool live = lg.grp < lg.G && row < R;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
            const int j0 = 2 * (32 * c + lg.i), j1 = j0 + 1;
            const bool l = live && lane_limb[c];
            s0[u][c] = l && j0 < kuse ? (u64)__ldg(sd + row * kd + j0) : 0;
            s1[u][c] = l && j1 < kuse ? (u64)__ldg(sd + row * kd + j1) : 0;
        }
        a[u] = live ? __ldg(af + row) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < RL; ++u) {
        const i64 row = row0 + u * lg.G;
        bool limb[NCH];
        u64 x[NCH];
        const double alpha = fmin(fmax(floor(a[u]), 0.0), dimf);
        const u64 ai = (u64)(i64)alpha;
        DigitCarry dc = {0, 0, 0};
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
            limb[c] = lane_limb[c] && row < R;
            x[c] = lane_digits(lg, limb[c], s0[u][c] + ai * n0[c], s1[u][c] + ai * n1[c], dc,
                               NCH > 1);
        }
        if (exact) {
            row_correct(lg, limb, x, P, row_geq(lg, limb, x, MmP), true);  // x was below 0
            row_correct(lg, limb, x, P, row_geq(lg, limb, x, P), false);   // x >= P
            if (center) row_correct(lg, limb, x, P, row_geq(lg, limb, x, Ph), false);
        } else {
            row_correct(lg, limb, x, P, a[u] - alpha > 0.5, false);
        }
#pragma unroll
        for (int c = 0; c < NCH; ++c)
            if (limb[c]) out[row * k_out + 32 * c + lg.i] = x[c];
    }
}

extern "C" int gpqhe_rns_decompose(i64 S, i64 n, int K, i64 ss, i64 sn, int dim, int J,
                                   void *out, const void *a, const void *w, const void *ps,
                                   i64 psd, const void *pinv, i64 pvd, int src_bits,
                                   void *stream) {
    if (K < 1) return (int)cudaErrorInvalidValue;
    const int last = K - (K - 1) / DEC_KC * DEC_KC;
    const DecArgs g = {(u64 *)out, S, n, ss, sn, K, dim, J, src_bits, (const u64 *)a,
                       (const u64 *)w, {(const u64 *)ps, psd}, {(const u64 *)pinv, pvd},
                       FastDiv::of(K < DEC_KC ? K : DEC_KC), FastDiv::of(last)};
    const dim3 grid((unsigned)((n + DEC_ROWS - 1) / DEC_ROWS),
                    (unsigned)((dim + DEC_PRIMES - 1) / DEC_PRIMES),
                    (unsigned)(S < 65535 ? S : 65535));
    rns_decompose_kernel<<<grid, DEC_WARPS * 32, 0, (cudaStream_t)stream>>>(g);
    return (int)cudaGetLastError();
}

// The device's SMs, once the dynamic shared-memory limit of the persistent
// kernel in `slot` is raised to DS_SMEM on it (once a device and kernel);
// 0 on an error, in *rc.
static int persistent_sms(const void *kernel, int slot, cudaError_t *rc) {
    static bool ready[64][4];
    static int sms[64];
    int dev = 0;
    *rc = cudaGetDevice(&dev);
    if (*rc != cudaSuccess || dev >= 64) {
        if (*rc == cudaSuccess) *rc = cudaErrorInvalidValue;
        return 0;
    }
    if (!ready[dev][slot]) {
        *rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DS_SMEM);
        if (*rc == cudaSuccess && !sms[dev])
            *rc = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
        if (*rc != cudaSuccess) return 0;
        ready[dev][slot] = true;
    }
    return sms[dev];
}

// limbs [S, n, K] (strides ss, sn, 1) -> residues [S, dim, n] on the tensor
// cores; table: u8 [nb dim, tdepth] (rns_cuda.decompose_table: tdepth a
// multiple of DS_DEPTH, >= 4 K), its rows 16-byte aligned.
extern "C" int gpqhe_rns_decompose_mma(i64 S, i64 n, int K, i64 ss, i64 sn, int dim, int J,
                                       int nb, void *out, const void *a, const void *w,
                                       const void *ps, i64 psd, const void *pinv, i64 pvd,
                                       int src_bits, const void *table, int tdepth,
                                       void *stream) {
    void (*kernel)(u64 *, const u64 *, i64, i64, int, i64, i64, int, int, const u64 *, PerPrime,
                   PerPrime, int, const u8 *, int) =
        nb == 8 ? rns_decompose_kernel_mma<8> : nb == 4 ? rns_decompose_kernel_mma<4> : nullptr;
    if (!kernel || K < 1 || tdepth % DS_DEPTH || 4 * K > tdepth) return (int)cudaErrorInvalidValue;
    cudaError_t rc;
    const int sms = persistent_sms((const void *)kernel, nb == 8 ? 2 : 3, &rc);
    if (!sms) return (int)rc;
    const i64 items = S * ((n + DM_ROWS - 1) / DM_ROWS) * ((nb * dim + DM_COLS - 1) / DM_COLS);
    if (items == 0) return (int)cudaSuccess;
    const unsigned grid = (unsigned)(items < DS_BLOCKS_AN_SM * sms ? items : DS_BLOCKS_AN_SM * sms);
    kernel<<<grid, DS_WARPS * 32, DS_SMEM, (cudaStream_t)stream>>>(
        (u64 *)out, (const u64 *)a, S, n, K, ss, sn, dim, J, (const u64 *)w,
        {(const u64 *)ps, psd}, {(const u64 *)pinv, pvd}, src_bits, (const u8 *)table, tdepth);
    return (int)cudaGetLastError();
}

// table: u8 [2 ds, tdepth] (tdepth a multiple of DS_DEPTH, >= nb dim), its
// rows 16-byte aligned; nb the bytes a residue takes (8, or 4 for primes
// below 2^32).
extern "C" int gpqhe_rns_digit_sums(i64 S, int dim, i64 n, int nb, int kd, void *sums,
                                    void *af, const void *y, i64 ys, i64 yd, i64 yk,
                                    const void *scale, i64 scd, const void *ps, i64 psd,
                                    const void *pinv, i64 pvd, const void *inv_p, i64 ipd,
                                    const void *table, int tdepth, void *stream) {
    void (*kernel)(i64 *, double *, i64, int, i64, int, int, View, PerPrime, PerPrime,
                   PerPrime, const double *, i64, const u8 *, int) =
        nb == 8 ? rns_digit_split_kernel_mma<8> : nb == 4 ? rns_digit_split_kernel_mma<4>
                                                          : nullptr;
    if (!kernel || kd < 1 || tdepth % DS_DEPTH || (i64)nb * dim > tdepth)
        return (int)cudaErrorInvalidValue;
    cudaError_t rc;
    const int sms = persistent_sms((const void *)kernel, nb == 8, &rc);
    if (!sms) return (int)rc;
    const int lwn = 2 * kd <= DS_WARP_N ? 0 : 2 * kd <= 2 * DS_WARP_N ? 1 : 2;   // log2 wn
    const int bn = DS_WARP_N << lwn, bm = DS_TILE / bn;
    const i64 items = S * ((n + bm - 1) / bm) * ((2 * kd + bn - 1) / bn);
    if (items == 0) return (int)cudaSuccess;
    // persistent blocks, two an SM, each walking tiles gridDim.x apart
    const unsigned grid = (unsigned)(items < DS_BLOCKS_AN_SM * sms ? items : DS_BLOCKS_AN_SM * sms);
    const View yv = {(const u64 *)y, 0, ys, yd, yk};
    const PerPrime sc = {(const u64 *)scale, scd}, P = {(const u64 *)ps, psd},
                   V = {(const u64 *)pinv, pvd};
    kernel<<<grid, DS_WARPS * 32, DS_SMEM, (cudaStream_t)stream>>>(
        (i64 *)sums, (double *)af, S, dim, n, kd, lwn, yv, sc, P, V, (const double *)inv_p,
        ipd, (const u8 *)table, tdepth);
    return (int)cudaGetLastError();
}

extern "C" int gpqhe_rns_lift(i64 R, int kd, const void *sd, const void *af, int dim,
                              const void *negP16, int k_out, int exact, int center,
                              const void *P, const void *Phalf, const void *MminusP,
                              void *out, void *stream) {
    if (k_out < 1 || k_out > 32 * MAX_CHUNKS || kd < 0) return (int)cudaErrorInvalidValue;
    const int kuse = kd < 2 * k_out ? kd : 2 * k_out;
    const int nch = k_out <= 32 ? 1 : k_out <= 64 ? 2 : k_out <= 128 ? 4 : k_out <= 160 ? 5 : 6;
    const unsigned per_block = rows_a_block(k_out, lift_rows_a_lane(nch));
    const unsigned blocks = (unsigned)((R + per_block - 1) / per_block);
    cudaStream_t s = (cudaStream_t)stream;
#define LIFT(N) rns_lift_kernel<N><<<blocks, ROWWARP_THREADS, 0, s>>>(                      \
        (u64 *)out, R, kd, kuse, (const i64 *)sd, (const double *)af, (double)dim,         \
        (const i64 *)negP16, k_out, exact, center, (const i64 *)P, (const i64 *)Phalf,     \
        (const i64 *)MminusP)
    if (nch == 1) LIFT(1); else if (nch == 2) LIFT(2); else if (nch == 4) LIFT(4);
    else if (nch == 5) LIFT(5); else LIFT(6);
#undef LIFT
    return (int)cudaGetLastError();
}
