// RNS decompose and the CRT lift around the digit matmul, for Hopper (sm_90a).
//
// Replaces, on CUDA tensors, the torch chains of gpqhe_tpu_torch/ops/rns.py
// that XLA fuses inside each jitted program of the JAX package:
//   decompose    gpqhe_tpu/ops/rns.py:110 decompose_core (and the signed form
//                of gpqhe_tpu_torch/ring/poly.py, the JAX ring engine's
//                _decompose_signed): limbs [S, n, K] -> residues [S, dim, n];
//   digit_split  the first half of gpqhe_tpu/ops/rns.py:200 reconstruct_core:
//                residues y -> the transposed 16-bit digits of y as f64
//                [S, n, nd * dim] and the estimate af = sum_d y_d / p_d;
//   lift         its second half: the digit sums of the f64 matmul (which
//                stays torch.matmul, as the JAX package leaves it to XLA)
//                and af -> limbs, with the alpha correction, the 16-bit carry
//                walk and either the fast path (frac > 1/2 -> -P) or the exact
//                path (+-P, then centring).
// In torch a decompose of a 14-limb poly into 16 primes is ~440 launches and a
// reconstruct ~130; here a decompose is one launch and a reconstruct three
// (digit_split, the matmul, lift).
//
// What bounds them on the H100: bytes for digit_split and lift (a word in,
// four f64 digits out; a row of f64 digit sums in, u32 limbs out, in int64);
// multiplies for decompose: per output word and limb the 32 x 64-bit product
// of the limb and its constant, 2 IMAD and 2 IMAD.HI where the primes pass
// 32 bits.  The designs.  decompose: a block stages a tile of 64 rows'
// limbs in shared memory once, read coalesced, a signed row's limbs masked
// as they land; its 8 warps take 2 primes each of a tile of 16 and a lane 2
// rows, each output the sum over the limbs of limb_i c_i, c_i = 2^(32 i) R
// mod p made in the block from the weights, in four 32-bit words by a PTX
// carry chain, and one Montgomery reduction (the earlier design did K/2
// Montgomery products and modular adds an output, each thread re-reading
// its row from L2 for every 2 primes; PERF.md has both and the designs
// tried between, on the tensor cores among them).  digit_split: a block
// takes 64 coefficients, warp w the primes w, w + 8, ..., a lane a
// neighbouring pair, so that a warp stores 64 words of a digit row as 16-byte
// pairs; the estimate af is summed by each thread over its primes, then by
// warp 0 over the warps, in a fixed order (the earlier design: one thread a
// coefficient walking every prime, 128 blocks at 2^14 coefficients).  The
// lift reads and writes neighbouring words across a warp (rowwarp.cuh): a
// warp per row group, lane i of a group limb i, which reads digit sums 2i
// and 2i + 1, brings
// their carries to 0/1 by two shuffles and takes the rest, the compares and
// the +-P corrections from ballots; a row of more than 32 limbs (the exact
// path on bases of 17 primes and more: the key switch's 46 limbs at logn=14,
// 88 at logn=15) takes the whole warp, 32 limbs a chunk, its limbs in NCH
// registers a lane, at most MAX_CHUNKS (128 limbs, as before).  (The
// first design walked each row in global memory, digits kd words apart
// across a warp, and kept the limbs in a 1 KB local array, u64 r[128]:
// 8.5 us at 5.0x its byte bound.)
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include "mont.cuh"
#include "rowwarp.cuh"

typedef unsigned int u32;

#define MAX_CHUNKS 4      // the lift's chunks of 32 limbs a row: at most 128 limbs

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

// digit_split: a block takes SPLIT_COEFS coefficients (a pair a lane) of one
// slab, warp w the primes w, w + SPLIT_WARPS, ...
#define SPLIT_WARPS 8
#define SPLIT_COEFS 64
#define SPLIT_BATCH 4     // a warp's primes loaded before the first is worked

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
            u64 tsrc = 0;
            if (g.src_bits > 0) {
                // 2^src_bits mod p = (c_f 2^e) R^-1, src_bits = 32 f + e, f < K
                const u64 pinv = tp[2 * dl + 1], *w = g.w + (i64)(d0 + dl) * g.J;
                const int f = g.src_bits / 32 < g.K ? g.src_bits / 32 : g.K - 1;
                const int sh = g.src_bits - 32 * f;
                const u64 c = limb_const(w, f, c1_of(w, g.J, p, pinv), p, pinv);
                tsrc = mont_reduce(sh ? c >> (64 - sh) : 0, c << sh, p, pinv);
            }
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

// residues y [S, dim, n] (a view) -> Yt f64 [S, nd * dim, n], row t * dim + d
// holding digit t of y_d (the matmul takes its transpose, column-major, in
// place), and af f64 [S, n] = sum_d y_d / p_d.  With scale, y_d is first
// replaced by mont_mul(y_d, scale_d) (the phat^-1 multiply).  Lane l of warp
// w takes coefficients 2 l and 2 l + 1 of the block's SPLIT_COEFS and the
// primes w, w + SPLIT_WARPS, ...: a warp stores 64 neighbouring words of a
// digit row, a 16-byte pair a lane where n is even.  af: each thread sums
// its primes in order, then warp 0 the warps' sums in order (a fixed order,
// not the plain version's).
__global__ void __launch_bounds__(SPLIT_WARPS * 32)
rns_digit_split_kernel(double *__restrict__ Y, double *__restrict__ af, i64 S, int dim, i64 n,
                       int nd, View y, PerPrime scale, PerPrime P, PerPrime V,
                       const double *__restrict__ inv_p, i64 ipd) {
    __shared__ double part[SPLIT_WARPS][SPLIT_COEFS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const i64 k = (i64)blockIdx.x * SPLIT_COEFS + 2 * lane;
    const bool both = k + 1 < n, pair = both && n % 2 == 0;
    const bool vload = pair && y.sk == 1 && y.sd % 2 == 0 && y.sa % 2 == 0 &&
                       (reinterpret_cast<uintptr_t>(y.p) & 15) == 0;
    for (i64 s = blockIdx.y; s < S; s += gridDim.y) {
        double acc0 = 0.0, acc1 = 0.0;
        // SPLIT_BATCH primes' loads in flight before the first is worked
        for (int db = warp; k < n && db < dim; db += SPLIT_BATCH * SPLIT_WARPS) {
            u64 v0[SPLIT_BATCH], v1[SPLIT_BATCH];
#pragma unroll
            for (int u = 0; u < SPLIT_BATCH; ++u) {
                const int d = db + u * SPLIT_WARPS;
                v0[u] = v1[u] = 0;
                if (d >= dim) continue;
                if (vload) {
                    const longlong2 v = __ldg(reinterpret_cast<const longlong2 *>(
                        y.p + s * y.sa + d * y.sd + k));
                    v0[u] = (u64)v.x;
                    v1[u] = (u64)v.y;
                } else {
                    v0[u] = y.at(0, s, d, k);
                    if (both) v1[u] = y.at(0, s, d, k + 1);
                }
            }
#pragma unroll
            for (int u = 0; u < SPLIT_BATCH; ++u) {
                const int d = db + u * SPLIT_WARPS;
                if (d >= dim) continue;
                u64 x0 = v0[u], x1 = v1[u];
                if (scale.p) {
                    const u64 sc = scale.at(d), p = P.at(d), pv = V.at(d);
                    x0 = mont_mul(x0, sc, p, pv);
                    x1 = mont_mul(x1, sc, p, pv);
                }
                const double ip = __ldg(inv_p + d * ipd);
                acc0 += (double)(i64)x0 * ip;
                acc1 += (double)(i64)x1 * ip;
                double *row = Y + (s * nd * dim + d) * n + k;
                for (int t = 0; t < nd; ++t, row += (i64)dim * n) {
                    const double g0 = (double)((x0 >> (16 * t)) & 0xFFFF);
                    const double g1 = (double)((x1 >> (16 * t)) & 0xFFFF);
                    if (pair) {
                        *reinterpret_cast<double2 *>(row) = make_double2(g0, g1);
                    } else {
                        row[0] = g0;
                        if (both) row[1] = g1;
                    }
                }
            }
        }
        part[warp][2 * lane] = acc0;
        part[warp][2 * lane + 1] = acc1;
        __syncthreads();
        if (warp == 0 && k < n) {
            double a0 = part[0][2 * lane], a1 = part[0][2 * lane + 1];
#pragma unroll
            for (int w = 1; w < SPLIT_WARPS; ++w) {
                a0 += part[w][2 * lane];
                a1 += part[w][2 * lane + 1];
            }
            if (pair) {
                *reinterpret_cast<double2 *>(af + s * n + k) = make_double2(a0, a1);
            } else {
                af[s * n + k] = a0;
                if (both) af[s * n + k + 1] = a1;
            }
        }
        __syncthreads();
    }
}

// digit sums [R, kd] (f64 or int64, contiguous) and af [R] -> limbs [R, k_out]
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
// lane (four at two chunks kept a stack frame).
template <typename T, int NCH>
__global__ void __launch_bounds__(ROWWARP_THREADS)
rns_lift_kernel(u64 *out, i64 R, int kd, int kuse, const T *sd, const double *af, double dimf,
                const i64 *negP16, int k_out, int exact, int center, const i64 *Pl,
                const i64 *Phalf, const i64 *MminusP) {
    constexpr int RL = WARP_GROUPS / NCH;
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
            s0[u][c] = l && j0 < kuse ? (u64)(i64)__ldg(sd + row * kd + j0) : 0;
            s1[u][c] = l && j1 < kuse ? (u64)(i64)__ldg(sd + row * kd + j1) : 0;
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
        // x >= y over the row, y the constant limbs MmP (which 0), P (1) or
        // Ph (2), from the top chunk down
        auto compare = [&](int which) {
            bool ge = true, done = false;
#pragma unroll
            for (int c = NCH - 1; c >= 0; --c)
                lane_geq(lg, limb[c], x[c], which == 0 ? MmP[c] : which == 1 ? P[c] : Ph[c], ge,
                         done);
            return ge;
        };
        // x + P or x - P where `on`, carried chunk to chunk
        auto correct = [&](bool on, bool add) {
            u64 carry = 0;
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
                const u64 y = add ? lane_add(lg, limb[c], x[c], P[c], carry)
                                  : lane_sub(lg, limb[c], x[c], P[c], carry);
                x[c] = on ? y : x[c];
            }
        };
        if (exact) {
            correct(compare(0), true);          // x >= M - P: x was below 0
            correct(compare(1), false);         // x >= P
            if (center) correct(compare(2), false);
        } else {
            correct(a[u] - alpha > 0.5, false);
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

extern "C" int gpqhe_rns_digit_split(i64 S, int dim, i64 n, int nd, void *Y, void *af,
                                     const void *y, i64 ys, i64 yd, i64 yk,
                                     const void *scale, i64 scd, const void *ps, i64 psd,
                                     const void *pinv, i64 pvd, const void *inv_p, i64 ipd,
                                     void *stream) {
    const dim3 grid((unsigned)((n + SPLIT_COEFS - 1) / SPLIT_COEFS),
                    (unsigned)(S < 65535 ? S : 65535));
    const View yv = {(const u64 *)y, 0, ys, yd, yk};
    const PerPrime sc = {(const u64 *)scale, scd}, P = {(const u64 *)ps, psd},
                   V = {(const u64 *)pinv, pvd};
    rns_digit_split_kernel<<<grid, SPLIT_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (double *)Y, (double *)af, S, dim, n, nd, yv, sc, P, V, (const double *)inv_p, ipd);
    return (int)cudaGetLastError();
}

// digits_f64: 1 when the digit sums are f64 (the matmul's output), 0 for int64.
extern "C" int gpqhe_rns_lift(i64 R, int kd, int digits_f64, const void *sd, const void *af,
                              int dim, const void *negP16, int k_out, int exact, int center,
                              const void *P, const void *Phalf, const void *MminusP,
                              void *out, void *stream) {
    if (k_out < 1 || k_out > 32 * MAX_CHUNKS || kd < 0) return (int)cudaErrorInvalidValue;
    const int kuse = kd < 2 * k_out ? kd : 2 * k_out;
    const int nch = k_out <= 32 ? 1 : k_out <= 64 ? 2 : 4;
    const unsigned per_block = rows_a_block(k_out, WARP_GROUPS / nch);
    const unsigned blocks = (unsigned)((R + per_block - 1) / per_block);
    cudaStream_t s = (cudaStream_t)stream;
#define LIFT(TY, N) rns_lift_kernel<TY, N><<<blocks, ROWWARP_THREADS, 0, s>>>(           \
        (u64 *)out, R, kd, kuse, (const TY *)sd, (const double *)af, (double)dim,          \
        (const i64 *)negP16, k_out, exact, center, (const i64 *)P, (const i64 *)Phalf,     \
        (const i64 *)MminusP)
    if (digits_f64) {
        if (nch == 1) LIFT(double, 1); else if (nch == 2) LIFT(double, 2); else LIFT(double, 4);
    } else {
        if (nch == 1) LIFT(i64, 1); else if (nch == 2) LIFT(i64, 2); else LIFT(i64, 4);
    }
#undef LIFT
    return (int)cudaGetLastError();
}
