// Negacyclic NTT / INTT over RNS primes below 2^30 for Hopper (sm_90a),
// in single-word u32 arithmetic.
//
// Replaces the TPU kernel gpqhe_tpu/ops/ntt_pallas32.py::_ntt32_kernel
// (forward, inverse, and inverse scaled by n^-1 * phat^-1) for logp <= 29
// chains.  The arithmetic is that kernel's: Harvey-style lazy butterflies
// with Shoup multiplication against standard-domain twiddles z and
// companions z' = floor(z * 2^32 / p), in the bit-reversed twiddle order of
// gpqhe_tpu/ops/ntt.py (ref: src/ntt.c:37-73).  With p < 2^30, 4p < 2^32:
// coefficients stay < 4p in one u32 word through the stages.  The forward
// butterfly reduces x0 below 2p before it adds.  The inverse butterfly
// reduces BOTH inputs below 2p first: p is just above 2^29, so the sum of
// two values < 4p would wrap the word.  (The u64 kernel in ntt.cu adds first
// and reduces after; its words have the room, these do not.)  The output is
// reduced exactly to [0, p), so it is bit-identical to the plain twin in
// gpqhe_tpu_torch/ops/ntt.py over the same chain.
//
// The TPU kernel's 16-bit-partial high product is one __umulhi here; its
// [R,128] slab, transposes, stage fusion and prime/poly folds are TPU
// layout devices with no counterpart.
//
// Interface: residues are 64-bit words in device memory, as the rest of the
// package keeps them; the kernel narrows on load and widens on store.
//
// What bounds it on the H100: by the peaks, bytes.  A [4, 31, 2^14] call
// moves 124 slabs of 128 KiB in and 128 KiB out (64-bit words) plus, once
// per prime, n pairs of 4-byte twiddles: 36.6 MB, 10.9 us at 3.35 TB/s.  It
// does 124 * n/2 * log2(n) = 1.4e7 butterflies of three 32-bit multiplies
// each (one __umulhi, two low products): 4.3e7 IMAD, 2.5 us at the card's
// 16.75e12 IMAD/s.  A 16-slab call has a byte bound of 1.9 us, below the
// latency of a launch.
//
// Design (gpqhe_ntt32, csrc/ntt_passes.cuh): the slab is split n = n1 * n2
// and transformed by two kernels of many small blocks, a column pass (tiles
// of 16 columns: 64 bytes of u32 in shared memory, 128 bytes a row in
// device memory) and a row pass, with 8 coefficients a thread held in
// registers through up to 3 stages between exchanges in shared memory,
// compile-time loop bounds, and one 8-byte load per twiddle pair from the
// interleaved table.  The lazy intermediate between the passes (< 4p <
// 2^32) lies in the 64-bit output words.
//
// The first design (gpqhe_ntt32_v1: one 1024-thread block per slab with the
// slab as u32 words in shared memory, a barrier per stage, one grid-wide
// pass for the outer stage of n = 2^16) is kept below under its own entry
// point for measurement only: the smoke test times both in turns and holds
// them equal.  Nothing else calls it.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned int u32;
typedef unsigned long long u64;

#define SMEM_LOGN 15
#define SMEM_N (1 << SMEM_LOGN)
#define SMEM_THREADS 1024
#define STAGE_THREADS 256

__device__ __forceinline__ u32 shoup_mul(u32 x, u32 z, u32 zs, u32 p) {
    // x * z mod p, lazily: q = floor(x * zs / 2^32) is the true quotient or
    // one less, so the result lies in [0, 2p) for any x < 2^32 (the product
    // difference is taken mod 2^32, which holds it exactly).
    u32 q = __umulhi(x, zs);
    return x * z - q * p;
}

__device__ __forceinline__ u32 csub(u32 x, u32 m) { return x >= m ? x - m : x; }

__device__ __forceinline__ void fwd_bf(u32 &x0, u32 &x1, u32 z, u32 zs, u32 p) {
    // Cooley-Tukey: inputs < 4p, outputs < 4p.
    u32 a = csub(x0, 2 * p);
    u32 t = shoup_mul(x1, z, zs, p);
    x0 = a + t;
    x1 = a + 2 * p - t;
}

__device__ __forceinline__ void inv_bf(u32 &x0, u32 &x1, u32 z, u32 zs, u32 p) {
    // Gentleman-Sande: inputs < 4p, outputs x0 < 4p, x1 < 2p.
    u32 a = csub(x0, 2 * p);
    u32 b = csub(x1, 2 * p);
    x0 = a + b;
    x1 = shoup_mul(a + 2 * p - b, z, zs, p);
}

__device__ __forceinline__ u32 scale_reduce(u32 x, u32 s, u32 ss, u32 p) {
    return csub(shoup_mul(x, s, ss, p), p);
}

typedef uint2 wpair;
typedef u32 word;
#define COL_LOGC 4             // 16 columns of 4 bytes

#include "ntt_passes.cuh"

// a_in/a_out: [nslab, n] 64-bit words (values < p) with slab j on prime
// j % dim; tw: [dim, n, 2] u32 standard-domain twiddles interleaved with
// their Shoup companions (forward or inverse table); primes/scale/scale_s:
// u32[dim].  4 <= logn <= 16, primes < 2^30, a_in and a_out 16-byte aligned.
extern "C" int gpqhe_ntt32(const void *a_in, void *a_out, long long nslab, int dim,
                           int logn, const void *tw, const void *primes,
                           const void *scale, const void *scale_s, int inverse,
                           void *stream) {
    return ntt_two_pass((const u64 *)a_in, (u64 *)a_out, nslab, dim, logn,
                        (const wpair *)tw, (const u32 *)primes, (const u32 *)scale,
                        (const u32 *)scale_s, inverse, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// The first design, for measurement only (entry gpqhe_ntt32_v1).
// ---------------------------------------------------------------------------

// One slab (or one SMEM_N sub-block of a larger slab) per block.
// grid.x = nslab * nsub; src/dst are [nslab, n] 64-bit words; tw/tws [dim, n].
__global__ void ntt32_smem_kernel(const u64 *src, u64 *dst,
                                  int dim, int logn, int logsub,
                                  const u32 *__restrict__ tw,
                                  const u32 *__restrict__ tws,
                                  const u32 *__restrict__ primes,
                                  const u32 *__restrict__ scale,
                                  const u32 *__restrict__ scale_s,
                                  int inverse, int finish) {
    extern __shared__ u32 sm[];
    const int nsub_log = logn - logsub;
    const long long slab = blockIdx.x >> nsub_log;
    const int c = blockIdx.x & ((1 << nsub_log) - 1);
    const int d = (int)(slab % dim);
    const int m = 1 << logsub;
    const long long n = 1LL << logn;
    const u32 p = primes[d];
    const u32 *zt = tw + (long long)d * n;
    const u32 *zs = tws + (long long)d * n;
    const long long base = slab * n + (long long)c * m;

    for (int i = threadIdx.x; i < m; i += blockDim.x) sm[i] = (u32)src[base + i];
    __syncthreads();

    const int half = m >> 1;
    for (int s = 0; s < logsub; ++s) {
        // forward: len = m/2 .. 1; inverse: len = 1 .. m/2
        const int loglen = inverse ? s : logsub - 1 - s;
        const int len = 1 << loglen;
        // zeta index of local block k: n/(2 len) + c * m/(2 len) + k
        const long long zoff = (n >> (loglen + 1)) + ((long long)c << (logsub - loglen - 1));
        for (int i = threadIdx.x; i < half; i += blockDim.x) {
            const int k = i >> loglen;
            const int i0 = (k << (loglen + 1)) + (i & (len - 1));
            const u32 z = zt[zoff + k], zz = zs[zoff + k];
            u32 x0 = sm[i0], x1 = sm[i0 + len];
            if (inverse) inv_bf(x0, x1, z, zz, p);
            else fwd_bf(x0, x1, z, zz, p);
            sm[i0] = x0;
            sm[i0 + len] = x1;
        }
        __syncthreads();
    }

    if (finish) {
        if (inverse) {
            const u32 sc = scale[d], scs = scale_s[d];
            for (int i = threadIdx.x; i < m; i += blockDim.x)
                dst[base + i] = scale_reduce(sm[i], sc, scs, p);
        } else {
            for (int i = threadIdx.x; i < m; i += blockDim.x)
                dst[base + i] = csub(csub(sm[i], 2 * p), p);
        }
    } else {
        for (int i = threadIdx.x; i < m; i += blockDim.x) dst[base + i] = sm[i];
    }
}

// One butterfly stage of span 2*len over whole slabs in global memory.
// grid = (n/2 / STAGE_THREADS, nslab).  In place is safe: every element is
// read and written by exactly one thread of the stage.
__global__ void ntt32_stage_kernel(const u64 *src, u64 *dst, int dim, int logn,
                                   int loglen, const u32 *__restrict__ tw,
                                   const u32 *__restrict__ tws,
                                   const u32 *__restrict__ primes,
                                   const u32 *__restrict__ scale,
                                   const u32 *__restrict__ scale_s,
                                   int inverse, int finish) {
    const long long slab = blockIdx.y;
    const int d = (int)(slab % dim);
    const long long n = 1LL << logn;
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (n >> 1)) return;
    const u32 p = primes[d];
    const long long len = 1LL << loglen;
    const long long k = i >> loglen;
    const long long i0 = slab * n + (k << (loglen + 1)) + (i & (len - 1));
    const long long zi = (long long)d * n + (n >> (loglen + 1)) + k;
    u32 x0 = (u32)src[i0], x1 = (u32)src[i0 + len];
    if (inverse) inv_bf(x0, x1, tw[zi], tws[zi], p);
    else fwd_bf(x0, x1, tw[zi], tws[zi], p);
    if (finish) {  // last inverse stage: fold in the final scaling
        const u32 sc = scale[d], scs = scale_s[d];
        x0 = scale_reduce(x0, sc, scs, p);
        x1 = scale_reduce(x1, sc, scs, p);
    }
    dst[i0] = x0;
    dst[i0 + len] = x1;
}

static void stage(const u64 *src, u64 *dst, long long nslab, int dim, int logn,
                  int loglen, const u32 *tw, const u32 *tws, const u32 *primes,
                  const u32 *scale, const u32 *scale_s, int inverse, int finish,
                  cudaStream_t st) {
    const long long half = 1LL << (logn - 1);
    dim3 grid((unsigned)((half + STAGE_THREADS - 1) / STAGE_THREADS), (unsigned)nslab);
    ntt32_stage_kernel<<<grid, STAGE_THREADS, 0, st>>>(
        src, dst, dim, logn, loglen, tw, tws, primes, scale, scale_s, inverse, finish);
}

// a_in/a_out: [nslab, n] 64-bit words (values < p) with slab j on prime
// j % dim; tw/tws: [dim, n] u32 standard-domain twiddles and Shoup
// companions (forward or inverse table); primes/scale/scale_s: u32[dim].
// 4 <= logn <= 16, primes < 2^30, at most 65,535 slabs for n = 2^16 (grid.y
// of the stage pass).
extern "C" int gpqhe_ntt32_v1(const void *a_in, void *a_out, long long nslab, int dim,
                              int logn, const void *tw, const void *tws,
                              const void *primes, const void *scale,
                              const void *scale_s, int inverse, void *stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const u64 *in = (const u64 *)a_in;
    u64 *out = (u64 *)a_out;
    const u32 *z = (const u32 *)tw, *zs = (const u32 *)tws;
    const u32 *ps = (const u32 *)primes;
    const u32 *sc = (const u32 *)scale, *scs = (const u32 *)scale_s;
    const int logsub = logn < SMEM_LOGN ? logn : SMEM_LOGN;
    const int m = 1 << logsub;
    const size_t smem = (size_t)m * sizeof(u32);
    const int threads = (m / 2) < SMEM_THREADS ? (m / 2) : SMEM_THREADS;
    const long long blocks = nslab << (logn - logsub);
    cudaError_t e = cudaFuncSetAttribute(
        ntt32_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(SMEM_N * sizeof(u32)));
    if (e != cudaSuccess) return (int)e;

    if (!inverse) {
        // outer stages (span 2*len > m) in global memory, then the sub-blocks
        const u64 *src = in;
        for (int loglen = logn - 1; loglen >= logsub; --loglen) {
            stage(src, out, nslab, dim, logn, loglen, z, zs, ps, sc, scs, 0, 0, st);
            src = out;
        }
        ntt32_smem_kernel<<<(unsigned)blocks, threads, smem, st>>>(
            src, out, dim, logn, logsub, z, zs, ps, sc, scs, 0, 1);
    } else {
        const int whole = logsub == logn;
        ntt32_smem_kernel<<<(unsigned)blocks, threads, smem, st>>>(
            in, out, dim, logn, logsub, z, zs, ps, sc, scs, 1, whole);
        for (int loglen = logsub; loglen < logn; ++loglen)
            stage(out, out, nslab, dim, logn, loglen, z, zs, ps, sc, scs, 1,
                  loglen == logn - 1, st);
    }
    return (int)cudaGetLastError();
}
