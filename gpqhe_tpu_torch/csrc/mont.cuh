// Montgomery arithmetic on u64 words (R = 2^64) for the elementwise kernels
// of modmath.cu and rns.cu, and the operand views they share.
//
// The device counterparts of gpqhe_tpu/ops/modmath.py (mont_reduce 40,
// mont_mul 52, mulmod 58, addmod 98, submod 104) and of the plain torch
// versions in gpqhe_tpu_torch/ops/modmath.py (ref: src/reduce.c:36-66).
// Words live in int64 tensors with the bit patterns of the u64 values; here
// they are u64, and the high half of a product is __umul64hi.  Every result
// is the unique value in [0, p), so it equals the plain version bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef long long i64;

// hi:lo * R^-1 mod p for hi < p; pinv = p^-1 mod 2^64.  Output in [0, p).
__device__ __forceinline__ u64 mont_reduce(u64 hi, u64 lo, u64 p, u64 pinv) {
    const u64 t = __umul64hi(lo * pinv, p);
    return hi < t ? hi - t + p : hi - t;
}

// a * b * R^-1 mod p; needs a * b < R * p (any u64 a against b < p).
__device__ __forceinline__ u64 mont_mul(u64 a, u64 b, u64 p, u64 pinv) {
    return mont_reduce(__umul64hi(a, b), a * b, p, pinv);
}

// a * b mod p exactly, r2 = R^2 mod p.
__device__ __forceinline__ u64 mulmod(u64 a, u64 b, u64 p, u64 pinv, u64 r2) {
    return mont_mul(mont_mul(a, b, p, pinv), r2, p, pinv);
}

// a, b in [0, p), p < 2^63.
__device__ __forceinline__ u64 addmod(u64 a, u64 b, u64 p) {
    const u64 s = a + b;
    return s >= p ? s - p : s;
}

__device__ __forceinline__ u64 submod(u64 a, u64 b, u64 p) {
    return a < b ? a - b + p : a - b;
}

// An operand seen as [M, A, dim, n]: element (m, a, d, k) at
// p[m * sm + a * sa + d * sd + k * sk], strides in words (0 where the
// operand is broadcast).  The wrappers build these from torch strides.
struct View {
    const u64 *p;
    i64 sm, sa, sd, sk;
    __device__ __forceinline__ u64 at(i64 m, i64 a, i64 d, i64 k) const {
        return __ldg(p + m * sm + a * sa + d * sd + k * sk);
    }
};

// A per-prime constant: prime d's word at p[d * sd].
struct PerPrime {
    const u64 *p;
    i64 sd;
    __device__ __forceinline__ u64 at(i64 d) const { return __ldg(p + d * sd); }
};
