// Elementwise modular arithmetic over RNS residue stacks for Hopper (sm_90a).
//
// Replaces, on CUDA tensors, the torch chains of gpqhe_tpu_torch/ops/
// modmath.py, which are what XLA fuses inside each jitted program of the
// JAX package: gpqhe_tpu/ops/modmath.py mont_mul (52), mulmod (58),
// addmod (98), submod (104), and the fused products of the scheme engine
// (gpqhe_tpu/scheme/engine.py: the cross terms 535-538, the key products
// 554-555, the hoisted step's products and sums 929-938).  In torch one
// Montgomery product is 59 launches of emulated u64 arithmetic and one
// mulmod 118; here each entry is one launch.
//
// What bounds it on the H100: bytes.  A mulmod reads two words and writes
// one (24 bytes) against two Montgomery products of 14 IMAD each (a 64x64
// high and low product, u = lo * pinv, the high product u * p), so 3.35 TB/s
// against 16.75e12 IMAD/s puts the byte time at ~4x the operation time.  The
// design therefore reads every operand once, keeps the fused chains (cross
// terms, key products, the sums over the baby-step axis) in registers, and
// has each warp read 32 consecutive words of a row.  At the paths' sizes
// (1-8 MB an operand, L2-resident) a launch is one wave or a few, and what
// remains is the launch itself and each SM's multiply chains: the
// elementwise kernel (mulmod, mont_mul, addmod, submod) is launched with
// programmatic stream serialization, gives a thread EW_WORDS words as
// 16-byte pairs, issues all of its loads before the first reduction, makes
// each row's bases once (no 64-bit multiply a word for its address), and
// reduces a mulmod once (Barrett, 14 IMAD a word) where the fused kernels
// take two Montgomery products.
//
// Layout: every operand is a View [M, A, dim, n] with word strides (a
// broadcast axis has stride 0), so batched, broadcast and strided views
// (the key bank's row slices) are read in place.  The grid is x over n,
// y over the primes, z over A, the last two walked in loops past 65535;
// per-prime constants are loaded once per row.  Outputs are contiguous
// [nout, A, dim, n].
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include "mont.cuh"

enum { OP_MONT_MUL = 0, OP_MULMOD = 1, OP_ADDMOD = 2, OP_SUBMOD = 3 };
enum { SUM_PLAIN = 0, SUM_PRODUCTS = 1, SUM_PRODUCTS_TIMES = 2 };

struct Grid {
    i64 A, dim, n;
    __device__ __forceinline__ i64 out(i64 a, i64 d, i64 k) const { return (a * dim + d) * n + k; }
    __device__ __forceinline__ i64 slab() const { return A * dim * n; }
};

// mm_ew_kernel's work split: a block of at most EW_THREADS threads takes
// 2 EW_PAIRS T words of one row (T its threads), a thread EW_PAIRS 16-byte
// pairs of them, pair j at words k0 + 2 j T and k0 + 2 j T + 1, so that a
// warp's loads of one pair cover 512 neighbouring bytes.
#define EW_THREADS 256
#define EW_PAIRS 2
#define EW_WORDS (2 * EW_PAIRS)

// The thread's words of one operand row (row: the word at k = 0; sk its
// word stride along n).  A row of unit stride, 16-byte aligned, that holds
// every word of the thread is read in 16-byte pairs; a row of stride 0 (a
// per-row constant) is one word; any other (strided, one word off
// alignment, or the row's tail) word by word, words past n left 0.
__device__ __forceinline__ void ew_load(u64 (&w)[EW_WORDS], const u64 *row, i64 sk, int k0,
                                        int step, int n, bool whole) {
    if (sk == 1 && whole && ((size_t)row & 15) == 0) {
#pragma unroll
        for (int j = 0; j < EW_PAIRS; ++j) {
            const ulonglong2 t = __ldg((const ulonglong2 *)(row + k0 + j * step));
            w[2 * j] = t.x;
            w[2 * j + 1] = t.y;
        }
    } else if (sk == 0) {
        const u64 c = __ldg(row);
#pragma unroll
        for (int i = 0; i < EW_WORDS; ++i) w[i] = c;
    } else {
#pragma unroll
        for (int i = 0; i < EW_WORDS; ++i) {
            const int k = k0 + (i >> 1) * step + (i & 1);
            w[i] = k < n ? __ldg(row + (i64)k * sk) : 0;
        }
    }
}

// The thread's words of one contiguous output row, in 16-byte pairs where
// the row is aligned and holds them all, else word by word below n.
__device__ __forceinline__ void ew_store(u64 *row, const u64 (&r)[EW_WORDS], int k0, int step,
                                         int n, bool whole) {
    if (whole && ((size_t)row & 15) == 0) {
#pragma unroll
        for (int j = 0; j < EW_PAIRS; ++j)
            *(ulonglong2 *)(row + k0 + j * step) = make_ulonglong2(r[2 * j], r[2 * j + 1]);
    } else {
#pragma unroll
        for (int i = 0; i < EW_WORDS; ++i) {
            const int k = k0 + (i >> 1) * step + (i & 1);
            if (k < n) row[k] = r[i];
        }
    }
}

// mulmod's one reduction (Barrett) for residues a, b < p < 2^62 of k bits:
// with x = floor(ab / 2^(k-1)) < 2^(k+1) and mu = floor(2^(k+63) / p) < 2^64
// (a per-prime constant: the wrapper's table, built once per basis),
// q = floor(x mu / 2^64) is floor(ab / p) or up to 2 below it, so ab - q p
// lies in [0, 3p) and two conditional subtractions leave it in [0, p).  14
// IMAD a word (the 128-bit product ab: 7, the high product x mu: 4, the low
// product q p: 3) where the Montgomery pair of mont.cuh's mulmod takes 28.
__device__ __forceinline__ u64 barrett_mulmod(u64 a, u64 b, u64 p, u64 mu, int k) {
    const u64 lo = a * b, hi = __umul64hi(a, b);
    const u64 x = (lo >> (k - 1)) | (hi << (65 - k));
    u64 r = lo - __umul64hi(x, mu) * p;
    r = r >= p ? r - p : r;
    return r >= p ? r - p : r;
}

// mm_ew_kernel is launched with programmatic stream serialization (as the
// NTT passes are): its blocks may be scheduled while the kernel before it
// in the stream still runs, and wait here, before they touch device memory,
// until that kernel has completed and its writes are visible.  A block
// releases its own dependents at once: they too wait for this grid to
// complete.  That hides the launch between neighbouring kernels, the
// larger part of a launch at the paths' sizes.
__device__ __forceinline__ void grid_dependency_wait() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_release() {
    asm volatile("griddepcontrol.launch_dependents;");
}

// out = x op y for one of OP_*.  Each (a, d) row's bases and constants are
// made once; a thread loads all of its words of both operands before the
// first reduction, so their chains overlap.  n < 2^30 (the wrapper checks).
// mulmod takes residues a, b < p (one Barrett reduction against MU);
// mont_mul any u64 a against b < p (against V, p^-1 mod 2^64).
template <int OP>
__global__ void __launch_bounds__(EW_THREADS) mm_ew_kernel(u64 *out, Grid g, View x, View y,
                                                           PerPrime P, PerPrime V, PerPrime MU) {
    grid_dependency_wait();
    grid_dependency_release();
    const int n = (int)g.n, step = 2 * blockDim.x;
    const int k0 = blockIdx.x * EW_PAIRS * step + 2 * threadIdx.x;
    if (k0 >= n) return;
    const bool whole = k0 + (EW_PAIRS - 1) * step + 1 < n;
    for (i64 d = blockIdx.y; d < g.dim; d += gridDim.y) {
        const u64 p = P.at(d);
        const u64 pinv = OP == OP_MONT_MUL ? V.at(d) : 0;
        const u64 mu = OP == OP_MULMOD ? MU.at(d) : 0;
        const int kbits = 64 - __clzll((i64)p);
        for (i64 a = blockIdx.z; a < g.A; a += gridDim.z) {
            u64 u[EW_WORDS], v[EW_WORDS], r[EW_WORDS];
            ew_load(u, x.p + a * x.sa + d * x.sd, x.sk, k0, step, n, whole);
            ew_load(v, y.p + a * y.sa + d * y.sd, y.sk, k0, step, n, whole);
#pragma unroll
            for (int i = 0; i < EW_WORDS; ++i) {
                if (OP == OP_MONT_MUL) r[i] = mont_mul(u[i], v[i], p, pinv);
                else if (OP == OP_MULMOD) r[i] = barrett_mulmod(u[i], v[i], p, mu, kbits);
                else if (OP == OP_ADDMOD) r[i] = addmod(u[i], v[i], p);
                else r[i] = submod(u[i], v[i], p);
            }
            ew_store(out + (a * g.dim + d) * g.n, r, k0, step, n, whole);
        }
    }
}

template <int OP>
static void launch_ew(dim3 grid, unsigned threads, cudaStream_t st, u64 *out, const Grid &g,
                      const View &x, const View &y, const PerPrime &P, const PerPrime &V,
                      const PerPrime &R) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, mm_ew_kernel<OP>, out, g, x, y, P, V, R);
}

// x holds (x0, x1, y0, y1) on its M axis; out = (x0 y0, x0 y1 + x1 y0, x1 y1).
__global__ void mm_cross_kernel(u64 *out, Grid g, View x, PerPrime P, PerPrime V, PerPrime R2) {
    const i64 k = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= g.n) return;
    const i64 slab = g.slab();
    for (i64 d = blockIdx.y; d < g.dim; d += gridDim.y) {
        const u64 p = P.at(d), pinv = V.at(d), r2 = R2.at(d);
        for (i64 a = blockIdx.z; a < g.A; a += gridDim.z) {
            const u64 x0 = x.at(0, a, d, k), x1 = x.at(1, a, d, k);
            const u64 y0 = x.at(2, a, d, k), y1 = x.at(3, a, d, k);
            const i64 o = g.out(a, d, k);
            out[o] = mulmod(x0, y0, p, pinv, r2);
            out[slab + o] = addmod(mulmod(x0, y1, p, pinv, r2), mulmod(x1, y0, p, pinv, r2), p);
            out[2 * slab + o] = mulmod(x1, y1, p, pinv, r2);
        }
    }
}

// out = (x e0, x e1): the key switch's two products against the key halves.
__global__ void mm_keyprod_kernel(u64 *out, Grid g, View x, View e0, View e1, PerPrime P,
                                  PerPrime V, PerPrime R2) {
    const i64 k = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= g.n) return;
    const i64 slab = g.slab();
    for (i64 d = blockIdx.y; d < g.dim; d += gridDim.y) {
        const u64 p = P.at(d), pinv = V.at(d), r2 = R2.at(d);
        for (i64 a = blockIdx.z; a < g.A; a += gridDim.z) {
            const u64 u = x.at(0, a, d, k);
            const i64 o = g.out(a, d, k);
            out[o] = mulmod(u, e0.at(0, a, d, k), p, pinv, r2);
            out[slab + o] = mulmod(u, e1.at(0, a, d, k), p, pinv, r2);
        }
    }
}

// Sums over the M axis mod p.  SUM_PLAIN: sum x_m.  SUM_PRODUCTS: sum x_m y_m.
// SUM_PRODUCTS_TIMES: t_m = x_m y_m, out = (sum t_m w0_m, sum t_m w1_m).
// Every partial stays in [0, p), so the order of the sum does not matter.
template <int MODE>
__global__ void mm_sum_kernel(u64 *out, Grid g, i64 M, View x, View y, View w0, View w1,
                              PerPrime P, PerPrime V, PerPrime R2) {
    const i64 k = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= g.n) return;
    const i64 slab = g.slab();
    for (i64 d = blockIdx.y; d < g.dim; d += gridDim.y) {
        const u64 p = P.at(d);
        const u64 pinv = MODE != SUM_PLAIN ? V.at(d) : 0, r2 = MODE != SUM_PLAIN ? R2.at(d) : 0;
        for (i64 a = blockIdx.z; a < g.A; a += gridDim.z) {
            u64 s0 = 0, s1 = 0;
            for (i64 m = 0; m < M; ++m) {
                const u64 u = x.at(m, a, d, k);
                if (MODE == SUM_PLAIN) {
                    s0 = addmod(s0, u, p);
                } else {
                    const u64 t = mulmod(u, y.at(m, a, d, k), p, pinv, r2);
                    if (MODE == SUM_PRODUCTS) {
                        s0 = addmod(s0, t, p);
                    } else {
                        s0 = addmod(s0, mulmod(t, w0.at(m, a, d, k), p, pinv, r2), p);
                        s1 = addmod(s1, mulmod(t, w1.at(m, a, d, k), p, pinv, r2), p);
                    }
                }
            }
            const i64 o = g.out(a, d, k);
            out[o] = s0;
            if (MODE == SUM_PRODUCTS_TIMES) out[slab + o] = s1;
        }
    }
}

static dim3 grid_of(const Grid &g, unsigned threads) {
    const i64 bx = (g.n + threads - 1) / threads;
    return dim3((unsigned)bx, (unsigned)(g.dim < 65535 ? g.dim : 65535),
                (unsigned)(g.A < 65535 ? g.A : 65535));
}

static unsigned threads_of(i64 n) { return n >= 256 ? 256u : (unsigned)((n + 31) / 32 * 32); }

// mm_ew_kernel's launch: EW_WORDS words a thread along n.
static unsigned ew_threads_of(i64 n) { return threads_of((n + EW_WORDS - 1) / EW_WORDS); }

static dim3 ew_grid_of(const Grid &g, unsigned threads) { return grid_of(g, threads * EW_WORDS); }

static View view(const void *p, i64 sm, i64 sa, i64 sd, i64 sk) {
    View v = {(const u64 *)p, sm, sa, sd, sk};
    return v;
}

static PerPrime per_prime(const void *p, i64 sd) {
    PerPrime c = {(const u64 *)p, sd};
    return c;
}

// out: contiguous [A, dim, n]; x, y: [A, dim, n] views; p, pinv, mu per prime
// (pinv used by mont_mul only, mu = floor(2^(k+63) / p) by mulmod only).
// op: OP_*.
extern "C" int gpqhe_modmath_ew(int op, i64 A, i64 dim, i64 n, void *out,
                                const void *x, i64 xa, i64 xd, i64 xk,
                                const void *y, i64 ya, i64 yd, i64 yk,
                                const void *p, i64 pd, const void *pinv, i64 vd,
                                const void *mu, i64 md, void *stream) {
    const Grid g = {A, dim, n};
    const unsigned t = ew_threads_of(n);
    const dim3 b = ew_grid_of(g, t);
    cudaStream_t st = (cudaStream_t)stream;
    const View X = view(x, 0, xa, xd, xk), Y = view(y, 0, ya, yd, yk);
    const PerPrime P = per_prime(p, pd), V = per_prime(pinv, vd), R = per_prime(mu, md);
    switch (op) {
        case OP_MONT_MUL: launch_ew<OP_MONT_MUL>(b, t, st, (u64 *)out, g, X, Y, P, V, R); break;
        case OP_MULMOD: launch_ew<OP_MULMOD>(b, t, st, (u64 *)out, g, X, Y, P, V, R); break;
        case OP_ADDMOD: launch_ew<OP_ADDMOD>(b, t, st, (u64 *)out, g, X, Y, P, V, R); break;
        case OP_SUBMOD: launch_ew<OP_SUBMOD>(b, t, st, (u64 *)out, g, X, Y, P, V, R); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// out: contiguous [3, A, dim, n]; x: [4, A, dim, n] view.
extern "C" int gpqhe_modmath_cross(i64 A, i64 dim, i64 n, void *out,
                                   const void *x, i64 xm, i64 xa, i64 xd, i64 xk,
                                   const void *p, i64 pd, const void *pinv, i64 vd,
                                   const void *r2, i64 rd, void *stream) {
    const Grid g = {A, dim, n};
    const unsigned t = threads_of(n);
    mm_cross_kernel<<<grid_of(g, t), t, 0, (cudaStream_t)stream>>>(
        (u64 *)out, g, view(x, xm, xa, xd, xk), per_prime(p, pd), per_prime(pinv, vd),
        per_prime(r2, rd));
    return (int)cudaGetLastError();
}

// out: contiguous [2, A, dim, n]; x, e0, e1: [A, dim, n] views.
extern "C" int gpqhe_modmath_keyprod(i64 A, i64 dim, i64 n, void *out,
                                     const void *x, i64 xa, i64 xd, i64 xk,
                                     const void *e0, i64 ea, i64 ed, i64 ek,
                                     const void *e1, i64 fa, i64 fd, i64 fk,
                                     const void *p, i64 pd, const void *pinv, i64 vd,
                                     const void *r2, i64 rd, void *stream) {
    const Grid g = {A, dim, n};
    const unsigned t = threads_of(n);
    mm_keyprod_kernel<<<grid_of(g, t), t, 0, (cudaStream_t)stream>>>(
        (u64 *)out, g, view(x, 0, xa, xd, xk), view(e0, 0, ea, ed, ek), view(e1, 0, fa, fd, fk),
        per_prime(p, pd), per_prime(pinv, vd), per_prime(r2, rd));
    return (int)cudaGetLastError();
}

// out: contiguous [1 or 2, A, dim, n]; x, y, w0, w1: [M, A, dim, n] views
// (y unused by SUM_PLAIN, w0 and w1 by all but SUM_PRODUCTS_TIMES).
extern "C" int gpqhe_modmath_sum(int mode, i64 M, i64 A, i64 dim, i64 n, void *out,
                                 const void *x, i64 xm, i64 xa, i64 xd, i64 xk,
                                 const void *y, i64 ym, i64 ya, i64 yd, i64 yk,
                                 const void *w0, i64 vm, i64 va, i64 vd0, i64 vk,
                                 const void *w1, i64 um, i64 ua, i64 ud, i64 uk,
                                 const void *p, i64 pd, const void *pinv, i64 qd,
                                 const void *r2, i64 rd, void *stream) {
    const Grid g = {A, dim, n};
    const unsigned t = threads_of(n);
    const dim3 b = grid_of(g, t);
    cudaStream_t st = (cudaStream_t)stream;
    const View X = view(x, xm, xa, xd, xk), Y = view(y, ym, ya, yd, yk);
    const View W0 = view(w0, vm, va, vd0, vk), W1 = view(w1, um, ua, ud, uk);
    const PerPrime P = per_prime(p, pd), V = per_prime(pinv, qd), R = per_prime(r2, rd);
    switch (mode) {
        case SUM_PLAIN: mm_sum_kernel<SUM_PLAIN><<<b, t, 0, st>>>((u64 *)out, g, M, X, Y, W0, W1, P, V, R); break;
        case SUM_PRODUCTS: mm_sum_kernel<SUM_PRODUCTS><<<b, t, 0, st>>>((u64 *)out, g, M, X, Y, W0, W1, P, V, R); break;
        case SUM_PRODUCTS_TIMES:
            mm_sum_kernel<SUM_PRODUCTS_TIMES><<<b, t, 0, st>>>((u64 *)out, g, M, X, Y, W0, W1, P, V, R);
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
