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
// decompose does J = K/2 Montgomery products per output word, 14 IMAD each:
// at 14 limbs and 16 primes the operations (1.5 us) and the bytes (1.2 us)
// come out close.  The designs: decompose and digit_split take one thread per
// coefficient, which walks the limbs (decompose, 2 primes a thread: a
// [2^14, 14] -> 16-prime call is 1,024 blocks of 128 threads and took 9.8 us
// on an H100, against 13.2 us at 8 primes a thread in 256 blocks; PERF.md)
// or the primes (digit_split, whose digit rows a warp stores 32 coefficients
// at a time: 7.1 us, against 20.6 us when each thread stored its own row)
// with the running sum in a register.  The lift reads and writes
// neighbouring words across a warp (rowwarp.cuh): a warp per row group,
// lane i of a group limb i, which reads digit sums 2i and 2i + 1, brings
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

#define PRIMES_PER_THREAD 2
#define MAX_CHUNKS 4      // the lift's chunks of 32 limbs a row: at most 128 limbs

// limbs (u32 values in int64) [S, n, K] with strides (ss, sn, 1) -> residues
// [S, dim, n].  src_bits > 0: the input is two's complement of that width;
// a negative value decomposes as p - (|value| mod p) (0 stays 0).
__global__ void rns_decompose_kernel(u64 *out, i64 S, i64 n, int K, i64 ss, i64 sn, int dim, int J,
                                     const u64 *a, const u64 *w, PerPrime P, PerPrime V,
                                     int src_bits) {
    const i64 k = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= n) return;
    const int d0 = blockIdx.y * PRIMES_PER_THREAD;
    const int nd = dim - d0 < PRIMES_PER_THREAD ? dim - d0 : PRIMES_PER_THREAD;
    u64 p[PRIMES_PER_THREAD], pinv[PRIMES_PER_THREAD];
#pragma unroll
    for (int e = 0; e < PRIMES_PER_THREAD; ++e) {
        p[e] = e < nd ? P.at(d0 + e) : 1;
        pinv[e] = e < nd ? V.at(d0 + e) : 1;
    }
    const int full = src_bits / 32, rem = src_bits % 32;
    for (i64 s = blockIdx.z; s < S; s += gridDim.z) {
        const u64 *row = a + s * ss + k * sn;
        bool neg = false;
        if (src_bits > 0) neg = (__ldg(row + (src_bits - 1) / 32) >> ((src_bits - 1) % 32)) & 1;
        u64 acc[PRIMES_PER_THREAD];
#pragma unroll
        for (int e = 0; e < PRIMES_PER_THREAD; ++e) acc[e] = 0;
        u64 carry = 1;                       // the +1 of the negation ~a + 1
        for (int j = 0; j < J; ++j) {
            u64 half[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int i = 2 * j + h;
                u64 x = i < K ? __ldg(row + i) : 0;
                if (neg && i < K) {
                    x = (~x & M32) + carry;
                    carry = x >> 32;
                    x &= M32;
                    if (i > full || (i == full && rem == 0)) x = 0;
                    else if (i == full) x &= (1ull << rem) - 1;
                }
                half[h] = x;
            }
            const u64 c = half[0] | (half[1] << 32);
#pragma unroll
            for (int e = 0; e < PRIMES_PER_THREAD; ++e)
                if (e < nd) acc[e] = addmod(acc[e], mont_mul(c, __ldg(w + (i64)(d0 + e) * J + j),
                                                             p[e], pinv[e]), p[e]);
        }
#pragma unroll
        for (int e = 0; e < PRIMES_PER_THREAD; ++e)
            if (e < nd) out[(s * dim + d0 + e) * n + k] = neg && acc[e] ? p[e] - acc[e] : acc[e];
    }
}

// residues y [S, dim, n] (a view) -> Yt f64 [S, nd * dim, n], row t * dim + d
// holding digit t of y_d (the matmul takes its transpose, column-major, in
// place; a warp writes 32 neighbouring coefficients of one row), and af f64
// [S, n] = sum_d y_d / p_d.  With scale, y_d is first replaced by
// mont_mul(y_d, scale_d) (the phat^-1 multiply).
__global__ void rns_digit_split_kernel(double *Y, double *af, i64 S, int dim, i64 n, int nd, View y,
                                       PerPrime scale, PerPrime P, PerPrime V, const double *inv_p,
                                       i64 ipd) {
    const i64 k = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= n) return;
    for (i64 s = blockIdx.y; s < S; s += gridDim.y) {
        double *col = Y + s * (i64)(nd * dim) * n + k;
        double acc = 0.0;
        for (int d = 0; d < dim; ++d) {
            u64 v = y.at(0, s, d, k);
            if (scale.p) v = mont_mul(v, scale.at(d), P.at(d), V.at(d));
            acc += (double)(i64)v * __ldg(inv_p + d * ipd);
            for (int t = 0; t < nd; ++t)
                col[(i64)(t * dim + d) * n] = (double)((v >> (16 * t)) & 0xFFFF);
        }
        af[s * n + k] = acc;
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

static unsigned threads_of(i64 n) { return n >= 128 ? 128u : (unsigned)((n + 31) / 32 * 32); }

extern "C" int gpqhe_rns_decompose(i64 S, i64 n, int K, i64 ss, i64 sn, int dim, int J,
                                   void *out, const void *a, const void *w, const void *ps,
                                   i64 psd, const void *pinv, i64 pvd, int src_bits,
                                   void *stream) {
    const unsigned t = threads_of(n);
    const dim3 grid((unsigned)((n + t - 1) / t),
                    (unsigned)((dim + PRIMES_PER_THREAD - 1) / PRIMES_PER_THREAD),
                    (unsigned)(S < 65535 ? S : 65535));
    const PerPrime P = {(const u64 *)ps, psd}, V = {(const u64 *)pinv, pvd};
    rns_decompose_kernel<<<grid, t, 0, (cudaStream_t)stream>>>(
        (u64 *)out, S, n, K, ss, sn, dim, J, (const u64 *)a, (const u64 *)w, P, V, src_bits);
    return (int)cudaGetLastError();
}

extern "C" int gpqhe_rns_digit_split(i64 S, int dim, i64 n, int nd, void *Y, void *af,
                                     const void *y, i64 ys, i64 yd, i64 yk,
                                     const void *scale, i64 scd, const void *ps, i64 psd,
                                     const void *pinv, i64 pvd, const void *inv_p, i64 ipd,
                                     void *stream) {
    const unsigned t = threads_of(n);
    const dim3 grid((unsigned)((n + t - 1) / t), (unsigned)(S < 65535 ? S : 65535));
    const View yv = {(const u64 *)y, 0, ys, yd, yk};
    const PerPrime sc = {(const u64 *)scale, scd}, P = {(const u64 *)ps, psd},
                   V = {(const u64 *)pinv, pvd};
    rns_digit_split_kernel<<<grid, t, 0, (cudaStream_t)stream>>>(
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
