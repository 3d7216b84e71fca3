// K8: one stage of the four-step ("matmul") negacyclic NTT for Hopper
// (sm_90a), fused into one kernel whose modular matrix product runs on the
// tensor cores in u8 digit planes.
//
// Replaces, on CUDA tensors, what gpqhe_tpu/ops/ntt4.py computes for one
// stage: the Montgomery multiply that precedes it (the pre-twist psi^i of
// ntt4, 182, or the twiddle of intt4, 206), the transpose between the
// stages (189, 205), the modular product _moddot (130-173), and the
// Montgomery multiply that follows it (the twiddle of ntt4, 187; the
// untwist * n^-1 of intt4, 209, and the CRT reconstruct's p^-1,
// gpqhe_tpu/ring/poly.py:199-206).  A stage of slab s = (b, d) is
//   out[s][m][j] = post[d][m][j] scale[d] sum_k W_d[m][k] pre[d][k][j] X_s[k][j] mod p_d
// with X_s the slab's [K, J] words, or its transpose ([J, K] in memory).
//
// The product, exactly: W and X (after the pre-multiply, in [0, p)) are cut
// into P8 byte planes, W_v and X_u; mma.sync m16n8k32 u8 x u8 -> s32 sums
// the plane products of one anti-diagonal w = u + v over all k,
//   S_w = sum_{u+v=w} sum_k W_v[m][k] X_u[k][j] <= min(w + 1, 2 P8 - 1 - w) K 255^2 < 2^27
// (P8 = 8, K = 256), exact in s32.  The value sum_w S_w 2^(8 w) is folded a
// group of four anti-diagonals at a time: G_q = sum_{r<4} S_{4q+r} 2^(8 r) <
// 2^52 in a u64, then acc += G_q 2^(32 q) mod p by one Montgomery product
// against c32[d][q] = 2^(32 q) R mod p (4 products at P8 = 8, 2 at 4, 1 at
// 2).  Every result is the unique value in [0, p), so the kernel equals the
// plain version (the 16-bit f64 split -> torch.bmm -> combine of
// gpqhe_tpu_torch/ops/ntt4.py), and JAX, bit for bit.  P8 is the byte count
// of the plan's widest prime rounded up to 2, 4 or 8: the template's three
// instantiations (times the transpose).
//
// What bounds it on the H100: the tensor cores' u8 operations (2 M K J P8^2
// a slab: 8.7 us a stage at [4,16,2^14], P8 = 8, against 6.3 us of bytes).
// The design keeps every intermediate on chip: a block takes one slab's
// tile_m x TILE_J outputs, all of K; tile_m (tile_rows) is the most rows
// that let two blocks share an SM at K = 128, fewer where the grid would
// leave SMs short of two blocks.  W's byte planes of its rows come from the
// plan (u8 [dim, P8, M, K], built once) by cp.async, X's words of its
// columns are pre-multiplied and cut into byte planes as they land, K
// contiguous a column (the second stage's transpose comes free: its slab
// is K-contiguous already), a warp's loads of several items issued before
// any is cut so that their latencies overlap.  Plane rows are padded by 16
// bytes so that ldmatrix reads them without bank conflicts; an ldmatrix.x4
// of a plane [16 rows x 32 k] is exactly an A fragment of m16n8k32, and of
// two planes' [8 columns x 32 k] their B fragments.  A warp takes m16n8
// fragments of outputs in turn, each with all 2 P8 - 1 of its
// anti-diagonal sums (in two passes over k at P8 = 8, so that they fit 32
// registers): per 32 k it loads the P8 B fragments of X once and each A
// fragment of W once, and issues the P8^2 products, so that every fragment
// read from shared memory feeds up to P8 products and consecutive products
// go to different sums.  The sums are folded after the last k.  Only the
// residues reach device memory.
//
// Layouts: x contiguous [B, dim, K J] words (slab [K][J], or [J][K] when
// transposing); w8 [dim, P8, K, K] u8 (M = K); pre [dim, K, J] and post
// [dim, M, J] Montgomery words or null, scale [dim] or null; c32 [dim, 4];
// out [B, dim, M J].
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include "mma.cuh"
#include "mont.cuh"

#define NTT4_THREADS 256      // a block: 8 warps, 2 fragments each
#define NTT4_TILE_M8 64       // a block's output rows (W's rows) at P8 = 8, at most
#define NTT4_TILE_M4 128      // at P8 <= 4 (two blocks an SM at K = 128 either way)
#define NTT4_TILE_M_MIN 32    // the fewest, for small grids
#define NTT4_TILE_J 32        // a block's output columns
#define NTT4_WARP_M 16        // a warp's outputs: one m16n8 fragment
#define NTT4_WARP_J 8
#define NTT4_PAD 16           // bytes past a plane row's K in shared memory
#define NTT4_MAX_K 256        // the longest contraction (logn <= 16)
#define NTT4_LOAD_ITEMS 4     // X items a warp loads before it cuts any

constexpr int WARPS = NTT4_THREADS / 32;
constexpr int SMEM_MAX = 8 * (NTT4_TILE_M8 + NTT4_TILE_J) * (NTT4_MAX_K + NTT4_PAD);
static_assert(4 * (NTT4_TILE_M4 + NTT4_TILE_J) <= 8 * (NTT4_TILE_M8 + NTT4_TILE_J),
              "SMEM_MAX covers the widest tile at P8 = 4");
static_assert(NTT4_WARP_M == 16 && NTT4_WARP_J == 8, "a warp's outputs: one m16n8 fragment");
static_assert((NTT4_TILE_M_MIN / NTT4_WARP_M) * (NTT4_TILE_J / NTT4_WARP_J) % WARPS == 0,
              "the warps share a block's fragments evenly");

template <int P8, bool TRANSPOSE>
__global__ void __launch_bounds__(NTT4_THREADS, 2)
ntt4_stage_kernel(u64 *__restrict__ out, const u64 *__restrict__ x, const u8 *__restrict__ w8,
                  int B, int dim, int K, int J, int tile_m, int tiles_j,
                  const u64 *__restrict__ pre,
                  const u64 *__restrict__ post, const u64 *__restrict__ scale,
                  const u64 *__restrict__ ps, const u64 *__restrict__ pinv,
                  const u64 *__restrict__ c32) {
    extern __shared__ __align__(16) u8 smem[];
    const int M = K;
    const int KP = (K + 31) & ~31;              // K rounded up to the mma's depth
    const int KS = KP + NTT4_PAD;               // a plane row in shared memory
    u8 *ws = smem;                              // [P8][tile_m][KS]: W's planes
    u8 *xs = smem + P8 * tile_m * KS;           // [P8][TILE_J][KS]: X's planes
    const int lt = __ffs(tile_m) - 1;           // tile_m = 2^lt
    const int d = blockIdx.y / B, b = blockIdx.y - d * B;   // one prime's slabs adjacent
    const int s = b * dim + d;
    const int tm = blockIdx.x / tiles_j, tj = blockIdx.x - tm * tiles_j;
    const int m0 = tm * tile_m, j0 = tj * NTT4_TILE_J;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const u64 p = __ldg(ps + d), pv = __ldg(pinv + d);

    // W's byte planes, rows m0.. of each: 16 bytes a copy, zeros past M, K
    const u8 *wd = w8 + (i64)d * P8 * M * K;
    if ((K & 15) == 0) {
        const int cpr = KP / 16;
        for (int i = tid; i < (P8 * cpr) << lt; i += NTT4_THREADS) {
            const int r = i / cpr, c = i - r * cpr;     // r = v tile_m + row
            const int v = r >> lt, m = m0 + (r & (tile_m - 1));
            u8 *dst = ws + r * KS + 16 * c;
            if (m < M && 16 * c < K)
                cp_async16(smem_addr(dst), wd + ((i64)v * M + m) * K + 16 * c);
            else
                *(uint4 *)dst = make_uint4(0, 0, 0, 0);
        }
    } else {                                    // K = 4, 8: a word at a time
        const int wpr = KP / 4;
        for (int i = tid; i < (P8 * wpr) << lt; i += NTT4_THREADS) {
            const int r = i / wpr, c = i - r * wpr;
            const int v = r >> lt, m = m0 + (r & (tile_m - 1));
            u32 val = 0;
            if (m < M && 4 * c < K)
                val = __ldg((const u32 *)(wd + ((i64)v * M + m) * K + 4 * c));
            *(u32 *)(ws + r * KS + 4 * c) = val;
        }
    }

    // X's words of columns j0.., times pre, cut into byte planes as they
    // land: a lane takes 4 consecutive k of one column (8 columns x 4 groups
    // of k a warp item: coalesced loads, conflict-free 4-byte stores); a
    // warp issues the loads of LOAD_ITEMS items before it cuts any
    const u64 *xsl = x + (i64)s * K * J;
    const u64 *pr = pre ? pre + (i64)d * K * J : nullptr;
    const int items = (NTT4_TILE_J / 8) * (KP / 16);
    for (int it0 = warp; it0 < items; it0 += WARPS * NTT4_LOAD_ITEMS) {
        u64 wv[NTT4_LOAD_ITEMS][4], tv[NTT4_LOAD_ITEMS][4];
#pragma unroll
        for (int c = 0; c < NTT4_LOAD_ITEMS; ++c) {
            const int it = it0 + c * WARPS;
            const int j = j0 + (it % (NTT4_TILE_J / 8)) * 8 + (lane & 7);
            const int kq = (it / (NTT4_TILE_J / 8)) * 4 + (lane >> 3);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int k = 4 * kq + i;
                const bool ok = it < items && k < K && j < J;
                wv[c][i] = ok ? __ldg(xsl + (TRANSPOSE ? (i64)j * K + k : (i64)k * J + j)) : 0;
                tv[c][i] = ok && pr ? __ldg(pr + (i64)k * J + j) : 0;
            }
        }
#pragma unroll
        for (int c = 0; c < NTT4_LOAD_ITEMS; ++c) {
            const int it = it0 + c * WARPS;
            if (it >= items) break;
            const int jl = (it % (NTT4_TILE_J / 8)) * 8 + (lane & 7);
            const int kq = (it / (NTT4_TILE_J / 8)) * 4 + (lane >> 3);
            if (pr) {
#pragma unroll
                for (int i = 0; i < 4; ++i) wv[c][i] = mont_mul(wv[c][i], tv[c][i], p, pv);
            }
#pragma unroll
            for (int u = 0; u < P8; ++u) {
                u32 word = 0;
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    word |= (u32)((wv[c][i] >> (8 * u)) & 0xFFu) << (8 * i);
                *(u32 *)(xs + (u * NTT4_TILE_J + jl) * KS + 4 * kq) = word;
            }
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // the products: a warp takes the block's m16n8 fragments warp, warp +
    // WARPS, ..., each with all 2 P8 - 1 of its anti-diagonal sums, in
    // passes of PW sums (two at P8 = 8, so that the sums fit 32 registers
    // beside the fragments); a pass folds its groups of four.  This lane's
    // ldmatrix rows: A, W rows of the 16-row fragment, k halves by lane /
    // 16; B, the fragment's 8 X columns, k halves by lane / 8 % 2, two
    // planes by lane / 16
    constexpr int NW = 2 * P8 - 1, NG = (2 * P8 + 2) / 4;     // sums; groups of four
    constexpr int PW = P8 == 8 ? 8 : NW, NPASS = (NW + PW - 1) / PW;
    constexpr int FJ = NTT4_TILE_J / NTT4_WARP_J;
    const int frags = (tile_m / NTT4_WARP_M) * FJ;
    const int g = lane >> 2, t = lane & 3;
    const u32 a_lane0 = smem_addr(ws) + ((lane & 7) + 8 * ((lane >> 3) & 1)) * KS +
                        16 * (lane >> 4);
    const u32 b_lane0 = smem_addr(xs) + ((lane >> 4) * NTT4_TILE_J + (lane & 7)) * KS +
                        16 * ((lane >> 3) & 1);
    const u64 *po = post ? post + (i64)d * M * J : nullptr;
    u64 *o = out + (i64)s * M * J;
#pragma unroll 1
    for (int f = warp; f < frags; f += WARPS) {
        const int wm = (f / FJ) * NTT4_WARP_M, wj = (f % FJ) * NTT4_WARP_J;
        if (m0 + wm >= M || j0 + wj >= J) continue;         // past a small matrix
        const u32 a_lane = a_lane0 + wm * KS, b_lane = b_lane0 + wj * KS;
        const int j = j0 + wj + 2 * t;
        u64 acc[4] = {0, 0, 0, 0}, pw[4];
#pragma unroll
        for (int pass = 0; pass < NPASS; ++pass) {
            const int w0 = pass * PW;
            int S[PW][4];
#pragma unroll
            for (int w = 0; w < PW; ++w)
#pragma unroll
                for (int e = 0; e < 4; ++e) S[w][e] = 0;
#pragma unroll 1
            for (int k = 0; k < KP; k += 32) {
                u32 bf[P8][2];
#pragma unroll
                for (int u = 0; u < P8; u += 2) {
                    u32 r[4];
                    ldsm_x4(r, b_lane + u * NTT4_TILE_J * KS + k);
                    bf[u][0] = r[0], bf[u][1] = r[1], bf[u + 1][0] = r[2], bf[u + 1][1] = r[3];
                }
#pragma unroll
                for (int v = 0; v < P8; ++v) {
                    if (v + P8 - 1 < w0 || v >= w0 + PW) continue;    // no sum of this pass
                    u32 a[4];
                    ldsm_x4(a, a_lane + v * tile_m * KS + k);
#pragma unroll
                    for (int u = 0; u < P8; ++u)
                        if (u + v >= w0 && u + v < w0 + PW)
                            mma_u8(S[u + v - w0], a, bf[u][0], bf[u][1]);
                }
            }
            if (pass == NPASS - 1) {
                // the post-table words, loaded before the last folds
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int m = m0 + wm + g + 8 * (e >> 1);
                    pw[e] = po && m < M && j < J ? __ldg(po + (i64)m * J + j + (e & 1)) : 0;
                }
            }
            // the folds: a group of four sums into a u64, each group into
            // the residue by one Montgomery product against 2^(32 q) R mod p
#pragma unroll
            for (int q = w0 / 4; q < NG && 4 * q < w0 + PW; ++q) {
                const u64 c = __ldg(c32 + 4 * d + q);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    u64 grp = 0;
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        if (4 * q + r < NW) grp += (u64)(u32)S[4 * q + r - w0][e] << (8 * r);
                    acc[e] = addmod(acc[e], mont_mul(grp, c, p, pv), p);
                }
            }
        }

        // the epilogue: post and scale, two neighbouring columns a 16-byte
        // store
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if (po) acc[e] = mont_mul(acc[e], pw[e], p, pv);
            if (scale) acc[e] = mont_mul(acc[e], __ldg(scale + d), p, pv);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm + g + 8 * h;
            if (m < M && j < J)
                *(ulonglong2 *)(o + (i64)m * J + j) = make_ulonglong2(acc[2 * h], acc[2 * h + 1]);
        }
    }
}

typedef void (*StageKernel)(u64 *, const u64 *, const u8 *, int, int, int, int, int, int,
                            const u64 *, const u64 *, const u64 *, const u64 *, const u64 *,
                            const u64 *);

static StageKernel stage_kernel(int P8, int transpose) {
    switch (P8) {
        case 2: return transpose ? &ntt4_stage_kernel<2, true> : &ntt4_stage_kernel<2, false>;
        case 4: return transpose ? &ntt4_stage_kernel<4, true> : &ntt4_stage_kernel<4, false>;
        case 8: return transpose ? &ntt4_stage_kernel<8, true> : &ntt4_stage_kernel<8, false>;
        default: return nullptr;
    }
}

// The rows of W a block takes: the most that let two blocks share an SM's
// shared memory at K = 128, halved (to 32 at the fewest) while half of them
// would cover M or the grid would give an SM fewer than two blocks.
static int tile_rows(int P8, int K, int J, int slabs, int sms) {
    const int tiles_j = (J + NTT4_TILE_J - 1) / NTT4_TILE_J;
    int tm = P8 == 8 ? NTT4_TILE_M8 : NTT4_TILE_M4;
    while (tm > NTT4_TILE_M_MIN &&
           (tm / 2 >= K || (long long)((K + tm - 1) / tm) * tiles_j * slabs < 2LL * sms))
        tm /= 2;
    return tm;
}

// The wrapper checks B dim <= 65535 (grid.y), 4 <= K <= 256 with K % 4 == 0,
// J even, w8 16-byte aligned.
extern "C" int gpqhe_ntt4_stage(void *out, const void *x, const void *w8, int B, int dim, int K,
                                int J, int P8, int transpose, const void *pre, const void *post,
                                const void *scale, const void *ps, const void *pinv,
                                const void *c32, void *stream) {
    static bool ready[64][9][2];        // the shared-memory limit set, by device and kernel
    static int sms[64];                 // the device's SMs
    const StageKernel kernel = stage_kernel(P8, transpose);
    int dev = 0;
    if (!kernel || cudaGetDevice(&dev) != cudaSuccess || dev >= 64)
        return (int)cudaErrorInvalidValue;
    if (!ready[dev][P8][transpose != 0]) {
        cudaError_t rc = cudaFuncSetAttribute(
            (const void *)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (rc == cudaSuccess && !sms[dev])
            rc = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
        if (rc != cudaSuccess) return (int)rc;
        ready[dev][P8][transpose != 0] = true;
    }
    const int tile_m = tile_rows(P8, K, J, B * dim, sms[dev]);
    const int tiles_m = (K + tile_m - 1) / tile_m;
    const int tiles_j = (J + NTT4_TILE_J - 1) / NTT4_TILE_J;
    const dim3 grid(tiles_m * tiles_j, B * dim);
    const size_t smem = (size_t)P8 * (tile_m + NTT4_TILE_J) * (((K + 31) & ~31) + NTT4_PAD);
    kernel<<<grid, NTT4_THREADS, smem, (cudaStream_t)stream>>>(
        (u64 *)out, (const u64 *)x, (const u8 *)w8, B, dim, K, J, tile_m, tiles_j,
        (const u64 *)pre, (const u64 *)post, (const u64 *)scale, (const u64 *)ps,
        (const u64 *)pinv, (const u64 *)c32);
    return (int)cudaGetLastError();
}
