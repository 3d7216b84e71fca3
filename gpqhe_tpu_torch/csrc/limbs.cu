// Per-row big-integer chains on u32 limbs for Hopper (sm_90a).
//
// Replaces, on CUDA tensors, the torch chains of gpqhe_tpu_torch/ops/limbs.py
// that XLA fuses inside each jitted program of the JAX package
// (gpqhe_tpu/ops/limbs.py: add 44, add_scalar_bit 55, sub 68, neg, geq_const
// 87, mask_bits 111, rshift_round 144, select, from_digits16 210), plus the
// rescale composite rshift_round -> mask_bits -> resize of the scheme
// engine (gpqhe_tpu/scheme/engine.py:515-519).  In torch the carries and
// borrows are log-depth Kogge-Stone scans of some 10-30 launches an op; here
// one thread walks one row's limbs with the carry or borrow in a register,
// and every op is one launch.
//
// Layout: a limb tensor [..., K] (u32 values in int64) is seen as rows
// [R1, R2] of K limbs with strides (s1, s2, sk), so broadcast operands (a
// constant's [K] limbs) and views are read in place; a per-row operand (a
// bit, a mask) likewise, with a dtype flag (bool or int64).  Outputs are
// contiguous.
//
// What bounds it on the H100: bytes (a few integer operations per limb word
// read and written); a thread's loads are K words apart from its
// neighbour's, so each warp-wide load touches 32 sectors and the row's
// later limbs come from L1.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef long long i64;

#define M32 0xFFFFFFFFull

enum {
    OP_ADD = 0, OP_SUB = 1, OP_NEG = 2, OP_ADD_BIT = 3, OP_MASK = 4, OP_RSHIFT_ROUND = 5,
    OP_RESCALE = 6, OP_GEQ = 7, OP_SELECT = 8, OP_FROM_DIGITS = 9
};

struct Rows {
    const void *p;
    i64 s1, s2, sk;
    int kind;              // 0: int64 words, 1: f64 values, 2: bool bytes
    __device__ __forceinline__ u64 at(i64 r1, i64 r2, i64 i) const {
        const i64 o = r1 * s1 + r2 * s2 + i * sk;
        if (kind == 1) return (u64)(i64)__ldg((const double *)p + o);
        if (kind == 2) return (u64)__ldg((const unsigned char *)p + o);
        return (u64)__ldg((const i64 *)p + o);
    }
};

struct Args {
    i64 R1, R2;
    int K, k_out, t, nbits;
};

// bit t of the limbs a[0..K) (0 past the top)
__device__ __forceinline__ u64 limb_or_zero(const Rows &a, i64 r1, i64 r2, int i, int K) {
    return i < K ? a.at(r1, r2, i) : 0;
}

// floor(a / 2^t) + [a mod 2^t > 2^(t-1)] into k limbs, mod 2^(32 k)
// (ref: src/types.c:115-128), limb i written through put(i, v).
template <typename Put>
__device__ __forceinline__ void rshift_round_row(const Rows &a, i64 r1, i64 r2, int K, int t,
                                                 int k, Put put) {
    const int s = t / 32, r = t % 32;
    u64 carry = 0;
    if (t > 0) {
        const int hb_limb = (t - 1) / 32, hb_bit = (t - 1) % 32;
        const u64 h = limb_or_zero(a, r1, r2, hb_limb, K);
        bool low = hb_bit > 0 && (h & ((1ull << hb_bit) - 1)) != 0;
        for (int i = 0; i < hb_limb && !low; ++i) low = limb_or_zero(a, r1, r2, i, K) != 0;
        carry = ((h >> hb_bit) & 1) && low;
    }
    for (int i = 0; i < k; ++i) {
        u64 q = limb_or_zero(a, r1, r2, s + i, K);
        if (r) q = ((q >> r) | (limb_or_zero(a, r1, r2, s + i + 1, K) << (32 - r))) & M32;
        const u64 v = q + carry;
        put(i, v & M32);
        carry = v >> 32;
    }
}

template <int OP>
__global__ void limbs_kernel(void *out, Args g, Rows a, Rows b, Rows bit) {
    const i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= g.R1 * g.R2) return;
    const i64 r1 = row / g.R2, r2 = row % g.R2;
    const int K = g.K;
    if (OP == OP_GEQ) {
        bool ge = true;
        for (int i = K - 1; i >= 0; --i) {
            const u64 x = a.at(r1, r2, i), c = b.at(r1, r2, i);
            if (x != c) { ge = x > c; break; }
        }
        ((unsigned char *)out)[row] = ge;
        return;
    }
    u64 *o = (u64 *)out + row * g.k_out;
    if (OP == OP_ADD || OP == OP_SUB || OP == OP_NEG || OP == OP_ADD_BIT) {
        u64 c = OP == OP_ADD_BIT ? (bit.at(r1, r2, 0) != 0) : 0;
        for (int i = 0; i < K; ++i) {
            const u64 x = a.at(r1, r2, i);
            if (OP == OP_ADD) {
                const u64 s = x + b.at(r1, r2, i) + c;
                o[i] = s & M32;
                c = s >> 32;
            } else if (OP == OP_ADD_BIT) {
                const u64 s = x + c;
                o[i] = s & M32;
                c = s >> 32;
            } else {
                const u64 y = (OP == OP_SUB ? b.at(r1, r2, i) : x) + c;
                const u64 m = OP == OP_SUB ? x : 0;
                c = m < y;
                o[i] = (m - y) & M32;
            }
        }
    } else if (OP == OP_MASK) {
        const int full = g.nbits / 32, rem = g.nbits % 32;
        for (int i = 0; i < K; ++i) {
            const u64 x = a.at(r1, r2, i);
            o[i] = i < full ? x : (i == full && rem ? x & ((1ull << rem) - 1) : 0);
        }
    } else if (OP == OP_RSHIFT_ROUND) {
        rshift_round_row(a, r1, r2, K, g.t, g.k_out, [&](int i, u64 v) { o[i] = v; });
    } else if (OP == OP_RESCALE) {
        // rshift_round to K limbs, keep the low nbits, then resize to k_out
        const int full = g.nbits / 32, rem = g.nbits % 32, k_out = g.k_out;
        rshift_round_row(a, r1, r2, K, g.t, K, [&](int i, u64 v) {
            if (i >= k_out) return;
            o[i] = i < full ? v : (i == full && rem ? v & ((1ull << rem) - 1) : 0);
        });
        for (int i = K; i < k_out; ++i) o[i] = 0;
    } else if (OP == OP_SELECT) {
        const bool take_a = bit.at(r1, r2, 0) != 0;
        for (int i = 0; i < K; ++i) o[i] = take_a ? a.at(r1, r2, i) : b.at(r1, r2, i);
    } else if (OP == OP_FROM_DIGITS) {
        // 16-bit digit sums (each < 2^48) -> k_out limbs, one carry walk
        u64 carry = 0, lo = 0;
        for (int i = 0; i < 2 * g.k_out; ++i) {
            const u64 v = carry + limb_or_zero(a, r1, r2, i, K);
            carry = v >> 16;
            if (i & 1) o[i >> 1] = lo | ((v & 0xFFFF) << 16);
            else lo = v & 0xFFFF;
        }
    }
}

// a, b: limb rows [R1, R2, K] (b unused by NEG, ADD_BIT, MASK and the shifts);
// bit: per-row operand [R1, R2] (ADD_BIT's bit, SELECT's mask).  out:
// contiguous [R1 * R2, k_out] int64 limbs, or [R1 * R2] bytes for GEQ.  For
// FROM_DIGITS, K counts the digits of a.
extern "C" int gpqhe_limbs(int op, i64 R1, i64 R2, int K, int k_out, int t, int nbits,
                           void *out, const void *a, i64 a1, i64 a2, i64 ak, int akind,
                           const void *b, i64 b1, i64 b2, i64 bk,
                           const void *bit, i64 t1, i64 t2, int tkind, void *stream) {
    const Args g = {R1, R2, K, k_out, t, nbits};
    const Rows A = {a, a1, a2, ak, akind}, B = {b, b1, b2, bk, 0}, T = {bit, t1, t2, 0, tkind};
    const i64 rows = R1 * R2;
    const unsigned threads = 128;
    const unsigned blocks = (unsigned)((rows + threads - 1) / threads);
    cudaStream_t st = (cudaStream_t)stream;
    switch (op) {
#define CASE(OPC) case OPC: limbs_kernel<OPC><<<blocks, threads, 0, st>>>(out, g, A, B, T); break;
        CASE(OP_ADD) CASE(OP_SUB) CASE(OP_NEG) CASE(OP_ADD_BIT) CASE(OP_MASK)
        CASE(OP_RSHIFT_ROUND) CASE(OP_RESCALE) CASE(OP_GEQ) CASE(OP_SELECT) CASE(OP_FROM_DIGITS)
#undef CASE
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
