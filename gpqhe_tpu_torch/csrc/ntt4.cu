// K8: the four-step ("matmul") negacyclic NTT's elementwise halves for
// Hopper (sm_90a), around an f64 digit GEMM that stays torch.bmm.
//
// Replaces, on CUDA tensors, what gpqhe_tpu/ops/ntt4.py computes around its
// einsum: the digit extraction of _moddot (132-133) with the Montgomery
// multiply that precedes a stage, the pre-twist psi^i of ntt4 (182) or the
// twiddle of intt4 (206), and the transpose between the stages (189, 205):
// ntt4_split_kernel; the anti-diagonal sums, carry assembly and reduction
// mod p of _moddot (145-173) with the Montgomery multiply that follows a
// stage, the twiddle of ntt4 (187), the untwist * n^-1 of intt4 (209) and
// the CRT reconstruct's p^-1 (gpqhe_tpu/ring/poly.py:199-206):
// ntt4_combine_kernel.  A modular matrix product W @ X over a prime is
// split (X into P 16-bit digit planes in f64), the P x P digit products
// W_v X_u (one torch.bmm over the primes, W's planes stacked in the plan),
// and combine.  Every product entry is at most k (2^16 - 1)^2 < 2^40 for
// k <= 256 (logn <= 16) and an anti-diagonal sums at most 4 of them, so the
// f64 values are exact integers in any summation order.  P is the digit
// count of the plan's widest prime (4 on the 59-bit chain, 2 on logp=29,
// 1 on the logp=9 chain): JAX's other planes are zero.  Every result is the
// unique value in [0, p), so the kernels equal the plain versions in
// gpqhe_tpu_torch/ops/ntt4.py, and JAX, bit for bit.
//
// What bounds it on the H100: bytes.  split reads a word (and a table word)
// and writes P f64 planes, 16 + 8 P bytes for one Montgomery product (14
// IMAD); combine reads the P^2 f64 products of its word (128 bytes at P = 4)
// and a table word and writes one, for 1-3 Montgomery products and the
// post-multiply.  Both move each byte once: a thread a word (split four
// words of a 32 x 32 tile), neighbouring threads on neighbouring words of
// every plane; the transposing split stages its tile in shared memory so
// that both its loads and its stores are coalesced.  A first, simple design:
// the products' round trip through device memory (P^2 planes written by the
// GEMM, read by combine) is the cost a fused tensor-core kernel removes.
//
// Layouts (S = B dim slabs, slab s = b dim + d):
//   split:   x [S, R, C] words -> out [dim, K, B, P, J] f64, where
//            (K, J) = (R, C), or (C, R) when transposing; the GEMM's
//            operand [dim, K, B P J].  tab [dim, K, J] (or null) is indexed
//            in the output's coordinates.
//   GEMM:    W [dim, P M, K] (plane v in rows v M ..) @ X -> Y [dim, P M, B P J].
//   combine: Y -> out [S, M, J] words; tab [dim, M, J] and scale [dim] or
//            null.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include "mont.cuh"

#define SPLIT_TILE 32         // a split block's tile: 32 x 32 words
#define SPLIT_ROWS 8          // its threads: 32 x 8, four words each
#define COMBINE_THREADS 256   // a combine block: 256 words of one slab

template <int P, bool TRANSPOSE>
__global__ void __launch_bounds__(SPLIT_TILE * SPLIT_ROWS)
ntt4_split_kernel(double *__restrict__ out, const u64 *__restrict__ x, int B, int dim,
                  int R, int C, int tiles_c, const u64 *__restrict__ tab,
                  const u64 *__restrict__ ps, const u64 *__restrict__ pinv) {
    __shared__ u64 tile[TRANSPOSE ? SPLIT_TILE : 1][SPLIT_TILE + 1];
    const int s = blockIdx.y;
    const int b = s / dim, d = s - b * dim;
    const int tr = blockIdx.x / tiles_c, tc = blockIdx.x - tr * tiles_c;
    const int r0 = tr * SPLIT_TILE, c0 = tc * SPLIT_TILE;
    const int K = TRANSPOSE ? C : R, J = TRANSPOSE ? R : C;
    const u64 *xs = x + (i64)s * R * C;
    const u64 p = __ldg(ps + d), pv = __ldg(pinv + d);
    const int tx = threadIdx.x;
    if (TRANSPOSE) {
#pragma unroll
        for (int i = threadIdx.y; i < SPLIT_TILE; i += SPLIT_ROWS) {
            const int r = r0 + i, c = c0 + tx;
            if (r < R && c < C) tile[i][tx] = __ldg(xs + (i64)r * C + c);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = threadIdx.y; i < SPLIT_TILE; i += SPLIT_ROWS) {
        // the output's (k, j): word (r, c) of the input is (r, c), or (c, r)
        const int k = (TRANSPOSE ? c0 : r0) + i, j = (TRANSPOSE ? r0 : c0) + tx;
        if (k >= K || j >= J) continue;
        u64 w = TRANSPOSE ? tile[tx][i] : __ldg(xs + (i64)k * C + j);
        if (tab) w = mont_mul(w, __ldg(tab + ((i64)d * K + k) * J + j), p, pv);
        double *o = out + (((i64)d * K + k) * B + b) * P * J + j;
#pragma unroll
        for (int u = 0; u < P; ++u) o[(i64)u * J] = (double)((w >> (16 * u)) & 0xFFFFull);
    }
}

template <int P>
__global__ void __launch_bounds__(COMBINE_THREADS)
ntt4_combine_kernel(u64 *__restrict__ out, const double *__restrict__ y, int B, int dim,
                    int M, int logJ, const u64 *__restrict__ tab,
                    const u64 *__restrict__ scale, const u64 *__restrict__ ps,
                    const u64 *__restrict__ pinv, const u64 *__restrict__ cpow) {
    const int s = blockIdx.y;
    const int b = s / dim, d = s - b * dim;
    const int J = 1 << logJ, n = M << logJ;
    const int e = blockIdx.x * COMBINE_THREADS + threadIdx.x;
    if (e >= n) return;
    const int r = e >> logJ, c = e & (J - 1);
    // product W_v X_u of word (r, c) at Y[d, v M + r, b P + u, c]
    const i64 row = (i64)B * P * J;
    const double *yb = y + ((i64)d * P * M + r) * row + (i64)b * P * J + c;
    double S[2 * P - 1];
#pragma unroll
    for (int w = 0; w < 2 * P - 1; ++w) S[w] = 0.0;
#pragma unroll
    for (int v = 0; v < P; ++v)
#pragma unroll
        for (int u = 0; u < P; ++u) S[u + v] += __ldg(yb + (i64)v * M * row + u * J);
    // sum_w S_w 2^(16 w) < 2^(43 + 16 (2P - 2)) in NL 64-bit limbs, assembled
    // 16 bits at a time as _moddot does (every S_w < 2^42 is exact)
    constexpr int NL = (16 * (2 * P - 2) + 106) / 64;
    u64 L[NL];
#pragma unroll
    for (int g = 0; g < NL; ++g) L[g] = 0;
    u64 carry = 0;
#pragma unroll
    for (int w = 0; w < 4 * NL; ++w) {
        const u64 cur = carry + (w < 2 * P - 1 ? (u64)S[w] : 0ull);
        L[w >> 2] |= (cur & 0xFFFFull) << (16 * (w & 3));
        carry = cur >> 16;
    }
    // value mod p = sum_g mont(L_g, 2^(64 g) R mod p)
    const u64 p = __ldg(ps + d), pv = __ldg(pinv + d);
    u64 acc = mont_mul(L[0], __ldg(cpow + 3 * d), p, pv);
#pragma unroll
    for (int g = 1; g < NL; ++g)
        acc = addmod(acc, mont_mul(L[g], __ldg(cpow + 3 * d + g), p, pv), p);
    if (tab) acc = mont_mul(acc, __ldg(tab + (i64)d * n + e), p, pv);
    if (scale) acc = mont_mul(acc, __ldg(scale + d), p, pv);
    out[(i64)s * n + e] = acc;
}

template <int P>
static void launch_split(int transpose, dim3 grid, cudaStream_t st, double *out, const u64 *x,
                         int B, int dim, int R, int C, int tiles_c, const u64 *tab,
                         const u64 *ps, const u64 *pinv) {
    const dim3 block(SPLIT_TILE, SPLIT_ROWS);
    if (transpose)
        ntt4_split_kernel<P, true><<<grid, block, 0, st>>>(out, x, B, dim, R, C, tiles_c, tab,
                                                           ps, pinv);
    else
        ntt4_split_kernel<P, false><<<grid, block, 0, st>>>(out, x, B, dim, R, C, tiles_c, tab,
                                                            ps, pinv);
}

template <int P>
static void launch_combine(dim3 grid, cudaStream_t st, u64 *out, const double *y, int B, int dim,
                           int M, int logJ, const u64 *tab, const u64 *scale, const u64 *ps,
                           const u64 *pinv, const u64 *cpow) {
    ntt4_combine_kernel<P><<<grid, COMBINE_THREADS, 0, st>>>(out, y, B, dim, M, logJ, tab, scale,
                                                             ps, pinv, cpow);
}

// out: [dim, K, B, P, J] f64; x: contiguous [B, dim, R, C] words; the
// wrapper checks B dim <= 65535 (grid.y).
extern "C" int gpqhe_ntt4_split(void *out, const void *x, int B, int dim, int R, int C, int P,
                                int transpose, const void *tab, const void *ps,
                                const void *pinv, void *stream) {
    const int tiles_r = (R + SPLIT_TILE - 1) / SPLIT_TILE;
    const int tc = (C + SPLIT_TILE - 1) / SPLIT_TILE;     // tiles along a row
    const dim3 grid(tiles_r * tc, B * dim);
    cudaStream_t st = (cudaStream_t)stream;
    double *o = (double *)out;
    const u64 *xx = (const u64 *)x, *t = (const u64 *)tab, *pp = (const u64 *)ps,
              *pv = (const u64 *)pinv;
    switch (P) {
        case 1: launch_split<1>(transpose, grid, st, o, xx, B, dim, R, C, tc, t, pp, pv); break;
        case 2: launch_split<2>(transpose, grid, st, o, xx, B, dim, R, C, tc, t, pp, pv); break;
        case 3: launch_split<3>(transpose, grid, st, o, xx, B, dim, R, C, tc, t, pp, pv); break;
        case 4: launch_split<4>(transpose, grid, st, o, xx, B, dim, R, C, tc, t, pp, pv); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// out: contiguous [B, dim, M, 2^logJ] words; y: contiguous [dim, P M, B P 2^logJ] f64.
extern "C" int gpqhe_ntt4_combine(void *out, const void *y, int B, int dim, int M, int logJ,
                                  int P, const void *tab, const void *scale, const void *ps,
                                  const void *pinv, const void *cpow, void *stream) {
    const int n = M << logJ;
    const dim3 grid((n + COMBINE_THREADS - 1) / COMBINE_THREADS, B * dim);
    cudaStream_t st = (cudaStream_t)stream;
    u64 *o = (u64 *)out;
    const double *yy = (const double *)y;
    const u64 *t = (const u64 *)tab, *sc = (const u64 *)scale, *pp = (const u64 *)ps,
              *pv = (const u64 *)pinv, *cp = (const u64 *)cpow;
    switch (P) {
        case 1: launch_combine<1>(grid, st, o, yy, B, dim, M, logJ, t, sc, pp, pv, cp); break;
        case 2: launch_combine<2>(grid, st, o, yy, B, dim, M, logJ, t, sc, pp, pv, cp); break;
        case 3: launch_combine<3>(grid, st, o, yy, B, dim, M, logJ, t, sc, pp, pv, cp); break;
        case 4: launch_combine<4>(grid, st, o, yy, B, dim, M, logJ, t, sc, pp, pv, cp); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
