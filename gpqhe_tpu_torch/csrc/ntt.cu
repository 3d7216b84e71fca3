// Negacyclic NTT / INTT over RNS primes for Hopper (sm_90a).
//
// Replaces the TPU kernel gpqhe_tpu/ops/ntt_pallas.py::_ntt_kernel (forward,
// inverse, and inverse scaled by n^-1 * phat^-1), with the same arithmetic:
// Harvey-style lazy butterflies with Shoup multiplication against
// standard-domain twiddles z and companions z' = floor(z * 2^64 / p), in the
// bit-reversed twiddle order of gpqhe_tpu/ops/ntt.py (ref: src/ntt.c:37-73).
// Coefficients stay < 4p through the stages and are reduced exactly to
// [0, p) at the end, so the output is bit-identical to the plain twin in
// gpqhe_tpu_torch/ops/ntt.py (the NTT is a linear map mod p; any exact
// algorithm gives the same fully reduced words).
//
// What bounds it on the H100: one n = 2^14 slab is 128 KiB read and written
// once, plus 2 * n * 8 B of twiddles (L2-resident across slabs of one prime),
// against n/2 * log2(n) = 114,688 butterflies, each one 64x64->128 high
// multiply (__umul64hi) and two 64-bit low multiplies: ~2 ops per byte of
// device traffic on a card whose 64-bit integer multiply is emulated with
// 32-bit IMADs.  So it is integer-multiply and latency bound, not memory
// bound: each stage is a __syncthreads() barrier over a block that holds
// the whole slab.
//
// Design: one thread block per (poly, prime) slab, the slab in dynamic
// shared memory (opt-in above 48 KB), all log2(n) stages in the block with a
// barrier between stages, twiddles read from global memory.  Slabs larger
// than SMEM_N words (n = 2^15, 2^16) first run their outer stages (those
// whose butterfly span 2*len exceeds SMEM_N) as one grid-wide pass per stage
// in global memory; after that every contiguous SMEM_N sub-block is an
// independent shared-memory NTT with the same global twiddle indexing.  The
// inverse runs the same split in the opposite order and folds the final
// scaling into its last global stage.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

#define SMEM_LOGN 14
#define SMEM_N (1 << SMEM_LOGN)
#define SMEM_THREADS 1024
#define STAGE_THREADS 256

__device__ __forceinline__ u64 shoup_mul(u64 x, u64 z, u64 zs, u64 p) {
    // x * z mod p, lazily: q = floor(x * zs / 2^64) is within one of the true
    // quotient, so the result lies in [0, 2p) for any x < 2^64.
    u64 q = __umul64hi(x, zs);
    return x * z - q * p;
}

__device__ __forceinline__ u64 csub(u64 x, u64 m) { return x >= m ? x - m : x; }

__device__ __forceinline__ void fwd_bf(u64 &x0, u64 &x1, u64 z, u64 zs, u64 p) {
    // Cooley-Tukey: inputs < 4p, outputs < 4p.
    u64 a = csub(x0, 2 * p);
    u64 t = shoup_mul(x1, z, zs, p);
    x0 = a + t;
    x1 = a + 2 * p - t;
}

__device__ __forceinline__ void inv_bf(u64 &x0, u64 &x1, u64 z, u64 zs, u64 p) {
    // Gentleman-Sande: inputs < 4p, outputs < 4p (x1 < 2p).
    u64 a = x0, b = x1;
    x0 = csub(a + b, 4 * p);
    x1 = shoup_mul(a + 4 * p - b, z, zs, p);
}

__device__ __forceinline__ u64 scale_reduce(u64 x, u64 s, u64 ss, u64 p) {
    return csub(shoup_mul(x, s, ss, p), p);
}

// One slab (or one SMEM_N sub-block of a larger slab) per block.
// grid.x = nslab * nsub; src/dst are [nslab, n]; tw/tws are [dim, n].
__global__ void ntt_smem_kernel(const u64 *src, u64 *dst,
                                int dim, int logn, int logsub,
                                const u64 *__restrict__ tw,
                                const u64 *__restrict__ tws,
                                const u64 *__restrict__ primes,
                                const u64 *__restrict__ scale,
                                const u64 *__restrict__ scale_s,
                                int inverse, int finish) {
    extern __shared__ u64 sm[];
    const int nsub_log = logn - logsub;
    const long long slab = blockIdx.x >> nsub_log;
    const int c = blockIdx.x & ((1 << nsub_log) - 1);
    const int d = (int)(slab % dim);
    const int m = 1 << logsub;
    const long long n = 1LL << logn;
    const u64 p = primes[d];
    const u64 *zt = tw + (long long)d * n;
    const u64 *zs = tws + (long long)d * n;
    const long long base = slab * n + (long long)c * m;

    for (int i = threadIdx.x; i < m; i += blockDim.x) sm[i] = src[base + i];
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
            const u64 z = zt[zoff + k], zz = zs[zoff + k];
            u64 x0 = sm[i0], x1 = sm[i0 + len];
            if (inverse) inv_bf(x0, x1, z, zz, p);
            else fwd_bf(x0, x1, z, zz, p);
            sm[i0] = x0;
            sm[i0 + len] = x1;
        }
        __syncthreads();
    }

    if (finish) {
        if (inverse) {
            const u64 sc = scale[d], scs = scale_s[d];
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
__global__ void ntt_stage_kernel(const u64 *src, u64 *dst, int dim, int logn,
                                 int loglen, const u64 *__restrict__ tw,
                                 const u64 *__restrict__ tws,
                                 const u64 *__restrict__ primes,
                                 const u64 *__restrict__ scale,
                                 const u64 *__restrict__ scale_s,
                                 int inverse, int finish) {
    const long long slab = blockIdx.y;
    const int d = (int)(slab % dim);
    const long long n = 1LL << logn;
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (n >> 1)) return;
    const u64 p = primes[d];
    const long long len = 1LL << loglen;
    const long long k = i >> loglen;
    const long long i0 = slab * n + (k << (loglen + 1)) + (i & (len - 1));
    const long long zi = (long long)d * n + (n >> (loglen + 1)) + k;
    u64 x0 = src[i0], x1 = src[i0 + len];
    if (inverse) inv_bf(x0, x1, tw[zi], tws[zi], p);
    else fwd_bf(x0, x1, tw[zi], tws[zi], p);
    if (finish) {  // last inverse stage: fold in the final scaling
        const u64 sc = scale[d], scs = scale_s[d];
        x0 = scale_reduce(x0, sc, scs, p);
        x1 = scale_reduce(x1, sc, scs, p);
    }
    dst[i0] = x0;
    dst[i0 + len] = x1;
}

static void stage(const u64 *src, u64 *dst, long long nslab, int dim, int logn,
                  int loglen, const u64 *tw, const u64 *tws, const u64 *primes,
                  const u64 *scale, const u64 *scale_s, int inverse, int finish,
                  cudaStream_t st) {
    const long long half = 1LL << (logn - 1);
    dim3 grid((unsigned)((half + STAGE_THREADS - 1) / STAGE_THREADS), (unsigned)nslab);
    ntt_stage_kernel<<<grid, STAGE_THREADS, 0, st>>>(
        src, dst, dim, logn, loglen, tw, tws, primes, scale, scale_s, inverse, finish);
}

// a_in/a_out: [nslab, n] with slab j on prime j % dim; tw/tws: [dim, n]
// standard-domain twiddles and Shoup companions (forward or inverse table);
// primes/scale/scale_s: [dim].  4 <= logn <= 16, primes < 2^61.
extern "C" int gpqhe_ntt(const void *a_in, void *a_out, long long nslab, int dim,
                         int logn, const void *tw, const void *tws,
                         const void *primes, const void *scale,
                         const void *scale_s, int inverse, void *stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const u64 *in = (const u64 *)a_in;
    u64 *out = (u64 *)a_out;
    const u64 *z = (const u64 *)tw, *zs = (const u64 *)tws;
    const u64 *ps = (const u64 *)primes;
    const u64 *sc = (const u64 *)scale, *scs = (const u64 *)scale_s;
    const int logsub = logn < SMEM_LOGN ? logn : SMEM_LOGN;
    const int m = 1 << logsub;
    const size_t smem = (size_t)m * sizeof(u64);
    const int threads = (m / 2) < SMEM_THREADS ? (m / 2) : SMEM_THREADS;
    const long long blocks = nslab << (logn - logsub);
    cudaError_t e = cudaFuncSetAttribute(
        ntt_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(SMEM_N * sizeof(u64)));
    if (e != cudaSuccess) return (int)e;

    if (!inverse) {
        // outer stages (span 2*len > m) in global memory, then the sub-blocks
        const u64 *src = in;
        for (int loglen = logn - 1; loglen >= logsub; --loglen) {
            stage(src, out, nslab, dim, logn, loglen, z, zs, ps, sc, scs, 0, 0, st);
            src = out;
        }
        ntt_smem_kernel<<<(unsigned)blocks, threads, smem, st>>>(
            src, out, dim, logn, logsub, z, zs, ps, sc, scs, 0, 1);
    } else {
        const int whole = logsub == logn;
        ntt_smem_kernel<<<(unsigned)blocks, threads, smem, st>>>(
            in, out, dim, logn, logsub, z, zs, ps, sc, scs, 1, whole);
        for (int loglen = logsub; loglen < logn; ++loglen)
            stage(out, out, nslab, dim, logn, loglen, z, zs, ps, sc, scs, 1,
                  loglen == logn - 1, st);
    }
    return (int)cudaGetLastError();
}
