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
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned int u32;
typedef unsigned long long u64;

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

