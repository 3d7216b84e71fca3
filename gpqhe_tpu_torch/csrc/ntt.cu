// Negacyclic NTT / INTT over RNS primes for Hopper (sm_90a), u64 words.
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
// What bounds it on the H100: by the peaks, bytes.  A [4, 16, 2^14] call
// reads and writes 64 slabs of 128 KiB once and the 16 primes' twiddle pairs
// once: 21.0 MB, 6.26 us at 3.35 TB/s, against 64 * n/2 * 14 = 7.3e6
// butterflies of one 64x64->128 high product and two 64-bit low products
// (about 10 32-bit IMAD: 4.4 us at 16.75e12 IMAD/s).  An 8-slab call has a
// byte bound of 1.25 us, below the latency of a launch.  So the design has
// to keep the whole card busy on few slabs and pay few synchronisations.
//
// Design (gpqhe_ntt, csrc/ntt_passes.cuh): the slab is split n = n1 * n2 and
// transformed by two kernels of many small blocks, a column pass and a row
// pass, with 8 coefficients a thread held in registers through up to 3
// stages between exchanges in shared memory, compile-time loop bounds, and
// one 16-byte load per twiddle pair from the interleaved table.  A
// [4, 16, 2^14] call is 1,024 column blocks and 1,024 row blocks of 128
// threads, where one block a slab would be 64; an 8-slab call 128 and 128
// where it would be 8.  The intermediate is written to the output and
// crosses L2.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

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

typedef ulonglong2 wpair;
typedef u64 word;
#define COL_LOGC 3             // 8 columns of 8 bytes

#include "ntt_passes.cuh"

// a_in/a_out: [nslab, n] with slab j on prime j % dim; tw: [dim, n, 2]
// standard-domain twiddles interleaved with their Shoup companions (forward
// or inverse table); primes/scale/scale_s: [dim].  4 <= logn <= 16, primes
// < 2^61, a_in and a_out 16-byte aligned.
extern "C" int gpqhe_ntt(const void *a_in, void *a_out, long long nslab, int dim,
                         int logn, const void *tw, const void *primes,
                         const void *scale, const void *scale_s, int inverse,
                         void *stream) {
    return ntt_two_pass((const u64 *)a_in, (u64 *)a_out, nslab, dim, logn,
                        (const wpair *)tw, (const u64 *)primes, (const u64 *)scale,
                        (const u64 *)scale_s, inverse, (cudaStream_t)stream);
}

