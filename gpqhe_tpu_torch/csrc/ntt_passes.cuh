// The two-pass schedule of the negacyclic NTT kernels for Hopper (sm_90a),
// shared by ntt.cu (u64 words) and ntt32.cu (u32 words).
//
// Included after the including file has defined
//   word       the arithmetic word (u64 or u32),
//   wpair      two words, .x a twiddle z and .y its Shoup companion,
//   COL_LOGC   log2 of the columns of a column tile (64 bytes of words),
//   csub, fwd_bf, inv_bf, scale_reduce   the lazy butterflies,
// and u64, the 64-bit word in which residues lie in device memory (the u32
// kernel narrows on load and widens on store).
//
// Schedule.  The index of a slab of n = n1 * n2 coefficients is i = r * n2 + c.
// The forward transform's stages len = n/2 .. n2 only join elements of one
// column c: they are an n1-point transform of each column with the twiddles
// 1 .. n1-1 of the prime's bit-reversed table (column pass).  The stages
// len = n2/2 .. 1 stay inside one row r: an n2-point transform of each row
// with the twiddles (n1 + r) * 2^j + k (row pass; the same indexing as a
// sub-block of a larger transform).  The forward runs column pass (in ->
// out), then row pass in place in out with the final reduction to [0, p);
// the inverse runs row pass (in -> out), then column pass in place with the
// scaling by n^-1 (or n^-1 phat^-1) folded in.  Between the passes the
// words in out are lazy (< 4p), and cross the L2 cache.  n <= 2^8 is the row
// pass alone (n1 = 1).  n1 = 2^ceil(logn/2): 2^14 = 2^7 * 2^7, 2^15 = 2^8 *
// 2^7, 2^16 = 2^8 * 2^8.
//
// Inside a pass of m = 2^L, a sequence (a column or a row) belongs to m/8
// threads; a thread holds 8 coefficients in registers and runs up to 3
// stages on them (a register group) before the sequence is exchanged
// through shared memory: L = 7 runs 3+2+2 stages with two exchanges, where
// the one-block-per-slab kernel had 7 barriers.  In a group whose lowest
// stage is lo the thread holds the elements whose index differs in bits
// a .. a+2, a = min(lo, L-3).  The lowest group has a = 0: a thread's 8
// elements are contiguous, so the stages len = 4, 2, 1 never touch shared
// memory, a thread's twiddle pairs of those stages are contiguous, and the
// inverse row pass loads 16 bytes a thread.  (The forward row pass would
// store 16 bytes a thread with threads 64 bytes apart, which writes half
// sectors and measured slower; it exchanges once more and stores 8 bytes a
// thread, a warp contiguous.)
// Every loop bound is a template constant: the compiler unrolls the groups
// and places the twiddle loads (one 16- or 8-byte load per (z, companion)
// pair, through the read-only path) ahead of the multiplies.
//
// Shared memory.  Column pass: word [idx][column], column fastest; the lanes
// that hold one element index are neighbouring columns, so they touch
// neighbouring words on both sides of an exchange and device memory in runs
// of 64 bytes (u64; 128 bytes for the u32 kernel's 16 columns).  A warp
// holds 4 (u32: 2) such runs; in the windows above bit 0 they are adjacent,
// in the contiguous window they lie 8 rows apart and meet two to a bank.
// Wider tiles would avoid that and measured slower: fewer, larger blocks
// fill the card worse.  Row pass: sequence s at s * (m + m/8), element idx
// at idx + (idx >> 3): one pad word per 8, so that lanes 8 words apart (the
// contiguous side of an exchange) fall on different banks; a row's threads
// are lanes of one warp, so its exchanges need __syncwarp() only.
//
// Launches.  Two kernels per transform on the caller's stream, each with
// programmatic stream serialization: a pass's blocks are scheduled while the
// kernel before it drains and wait in grid_dependency_wait(); a block
// releases its dependents when it has nothing left but its stores.
// One kernel with a thread-block cluster exchanging the tile through
// distributed shared memory was the alternative; see PERF.md for why the
// two-launch form was kept.
//
// The index maps (split, groups, element index, twiddle index, shared-
// memory index) are mirrored by the Python functions of the same names in
// ops/ntt_cuda.py; the CPU tests walk them block by block and thread by
// thread (tests/torch_ntt_schedule.py) and hold the result against the plain
// transform.

// Tile sizes: what measured best on an H100 (PERF.md lists what was tried).
#define ROW_THREADS 128        // threads of a row-pass block
#define COL_MAX_LOG_THREADS 9  // most threads of a column-pass block: 512
#define ONE_PASS_MAX_LOGN 8
#define GROUP_LOG 3            // a thread holds 2^3 coefficients

__host__ __device__ constexpr int ngroups(int L) { return (L + GROUP_LOG - 1) / GROUP_LOG; }
// widths of the register groups, top stages first: 4 = 2+2, 5 = 3+2, 6 = 3+3,
// 7 = 3+2+2, 8 = 3+3+2
__host__ __device__ constexpr int group_width(int L, int g) {
    return L / ngroups(L) + (g < L % ngroups(L) ? 1 : 0);
}
__host__ __device__ constexpr int group_lo(int L, int g) {
    int lo = L;
    for (int i = 0; i <= g; ++i) lo -= group_width(L, i);
    return lo;
}
__host__ __device__ constexpr int group_window(int L, int g) {
    return group_lo(L, g) < L - GROUP_LOG ? group_lo(L, g) : L - GROUP_LOG;
}

// Every pass is launched with programmatic stream serialization: its
// blocks may be scheduled while the kernel before it in the stream still
// runs, and wait here, before they touch device memory, until that kernel
// has completed and its writes are visible (a kernel that never releases its
// dependents, as every other kernel of the stream, releases them when it
// completes).  That hides the launch latency between the two passes and
// between transforms.
__device__ __forceinline__ void grid_dependency_wait() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
}
// Called when a block has nothing left but its stores.
__device__ __forceinline__ void grid_dependency_release() {
    asm volatile("griddepcontrol.launch_dependents;");
}

// index in its sequence of register e of thread t while the window is at bit a
__device__ __forceinline__ int element_index(int t, int e, int a) {
    return ((t >> a) << (a + GROUP_LOG)) | (e << a) | (t & ((1 << a) - 1));
}

// The stages of register group G (forward numbering) on a thread's registers.
// Stage loglen = a + b pairs registers (e0, e0 | 1 << b); its twiddle row is
// (base << (L-1-loglen)) + (element index >> (loglen+1)).
template <int L, bool INV, int G>
__device__ __forceinline__ void run_group(word (&x)[8], int t,
                                          const wpair *__restrict__ tw,
                                          unsigned base, word p) {
    constexpr int lo = group_lo(L, G), w = group_width(L, G), a = group_window(L, G);
    const unsigned hi = (unsigned)(t >> a);
#pragma unroll
    for (int s = 0; s < w; ++s) {
        const int b = INV ? lo - a + s : lo - a + w - 1 - s;
        const unsigned zrow = (base << (L - 1 - a - b)) + (hi << (GROUP_LOG - 1 - b));
#pragma unroll
        for (int h = 0; h < 4; ++h) {
            const int e0 = ((h >> b) << (b + 1)) | (h & ((1 << b) - 1));   // bit b clear
            const wpair z = __ldg(&tw[zrow + (e0 >> (b + 1))]);
            if (INV) inv_bf(x[e0], x[e0 | (1 << b)], z.x, z.y, p);
            else fwd_bf(x[e0], x[e0 | (1 << b)], z.x, z.y, p);
        }
    }
}

template <bool COL>
__device__ __forceinline__ void pass_barrier() {
    if (COL) __syncthreads();
    else __syncwarp();
}

// Registers held at window A_FROM -> shared memory -> registers at window A_TO.
// sm points at the thread's column (COL, stride C words) or at its row.
template <bool COL, int A_FROM, int A_TO>
__device__ __forceinline__ void exchange(word (&x)[8], word *sm, int t, int C, bool again) {
    if (again) pass_barrier<COL>();      // the previous exchange has been read
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        const int idx = element_index(t, e, A_FROM);
        sm[COL ? idx * C : idx + (idx >> GROUP_LOG)] = x[e];
    }
    pass_barrier<COL>();
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        const int idx = element_index(t, e, A_TO);
        x[e] = sm[COL ? idx * C : idx + (idx >> GROUP_LOG)];
    }
}

// Groups I.. of a pass in execution order (the inverse runs them bottom up).
template <int L, bool INV, bool COL, int I>
__device__ __forceinline__ void run_steps(word (&x)[8], word *sm, int t, int C,
                                          const wpair *__restrict__ tw,
                                          unsigned base, word p) {
    constexpr int NG = ngroups(L);
    if constexpr (I < NG) {
        constexpr int G = INV ? NG - 1 - I : I;
        if constexpr (I > 0) {
            constexpr int GP = INV ? NG - I : I - 1;
            exchange<COL, group_window(L, GP), group_window(L, G)>(x, sm, t, C, I > 1);
        }
        run_group<L, INV, G>(x, t, tw, base, p);
        run_steps<L, INV, COL, I + 1>(x, sm, t, C, tw, base, p);
    }
}

// Column pass: a block takes 2^logc adjacent columns of one slab, all n1 = 2^L
// rows.  grid.x = nslab * n2 >> logc, threads = 2^(logc + L - 3), dynamic
// shared memory 2^(logc + L) words.  src may be dst (the inverse runs in
// place): every element is read before the block's first barrier and
// written after its last, by threads of this block only.
template <int L, bool INV>
__global__ void __launch_bounds__(1 << COL_MAX_LOG_THREADS)
ntt_col_pass(const u64 *src, u64 *dst, int dim, int logn2, int logc,
             const wpair *__restrict__ tw, const word *__restrict__ primes,
             const word *__restrict__ scale, const word *__restrict__ scale_s) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    word *sm = reinterpret_cast<word *>(smem_raw);
    grid_dependency_wait();
    constexpr int NG = ngroups(L);
    constexpr int A0 = group_window(L, INV ? NG - 1 : 0), A1 = group_window(L, INV ? 0 : NG - 1);
    const int C = 1 << logc;
    const int j = threadIdx.x & (C - 1), t = threadIdx.x >> logc;
    const int bps_log = logn2 - logc;                     // blocks per slab
    const long long slab = blockIdx.x >> bps_log;
    const int c0 = (int)(blockIdx.x & ((1u << bps_log) - 1)) << logc;
    const int d = (int)(slab % dim);
    const word p = primes[d];
    const wpair *twr = tw + ((long long)d << (L + logn2));
    const long long g0 = (slab << (L + logn2)) + c0 + j;

    word x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
        x[e] = (word)src[g0 + ((long long)element_index(t, e, A0) << logn2)];
    run_steps<L, INV, true, 0>(x, sm + j, t, C, twr, 1u, p);
    if (INV) {
        const word sc = scale[d], scs = scale_s[d];
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = scale_reduce(x[e], sc, scs, p);
    }
    grid_dependency_release();
#pragma unroll
    for (int e = 0; e < 8; ++e)
        dst[g0 + ((long long)element_index(t, e, A1) << logn2)] = x[e];
}

// Row pass: a block takes ROW_THREADS / (n2/8) consecutive rows of n2 = 2^L
// contiguous elements; row q of the call lies at q * n2, on slab q >> logn1.
// grid.x = ceil(nseq / rows per block).  Threads past the last row repeat it
// and store nothing.  src may be dst (the forward runs in place): a row is
// read and written by the lanes of one warp, with a __syncwarp() between.
template <int L, bool INV>
__global__ void __launch_bounds__(ROW_THREADS)
ntt_row_pass(const u64 *src, u64 *dst, long long nseq, int dim, int logn1,
             const wpair *__restrict__ tw, const word *__restrict__ primes,
             const word *__restrict__ scale, const word *__restrict__ scale_s,
             int finish) {
    constexpr int TPS_LOG = L - GROUP_LOG;                // threads per row
    constexpr int S = ROW_THREADS >> TPS_LOG;
    constexpr int SEQ_WORDS = (1 << L) + (1 << TPS_LOG);
    constexpr int NG = ngroups(L);
    constexpr int A0 = group_window(L, INV ? NG - 1 : 0), A1 = group_window(L, INV ? 0 : NG - 1);
    __shared__ word sm[S * SEQ_WORDS];
    grid_dependency_wait();
    const int s = threadIdx.x >> TPS_LOG, t = threadIdx.x & ((1 << TPS_LOG) - 1);
    long long q = (long long)blockIdx.x * S + s;
    const bool active = q < nseq;
    if (!active) q = nseq - 1;
    const long long slab = q >> logn1;
    const unsigned r = (unsigned)(q & ((1LL << logn1) - 1));
    const int d = (int)(slab % dim);
    const word p = primes[d];
    const wpair *twr = tw + ((long long)d << (L + logn1));
    const u64 *g = src + (q << L);

    constexpr int TOP = L - GROUP_LOG;                    // the strided window
    word *smrow = sm + s * SEQ_WORDS;
    word x[8];
    if (A0 == 0) {                                 // 8 contiguous words
        const ulonglong2 *g2 = reinterpret_cast<const ulonglong2 *>(g + 8 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const ulonglong2 v = g2[e];
            x[2 * e] = (word)v.x;
            x[2 * e + 1] = (word)v.y;
        }
    } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = (word)g[element_index(t, e, A0)];
    }
    run_steps<L, INV, false, 0>(x, smrow, t, 0, twr, (1u << logn1) + r, p);
    if (finish) {
        if (INV) {
            const word sc = scale[d], scs = scale_s[d];
#pragma unroll
            for (int e = 0; e < 8; ++e) x[e] = scale_reduce(x[e], sc, scs, p);
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) x[e] = csub(csub(x[e], 2 * p), p);
        }
    }
    // contiguous registers would store half sectors: exchange once more
    constexpr int A_OUT = A1 == 0 ? TOP : A1;
    if (A1 == 0) exchange<false, 0, TOP>(x, smrow, t, 0, true);
    grid_dependency_release();
    if (!active) return;
    u64 *o = dst + (q << L);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[element_index(t, e, A_OUT)] = x[e];
}

struct PassArgs {
    long long nslab;
    int dim, logn1, logn2;
    const wpair *tw;
    const word *primes, *scale, *scale_s;
    cudaStream_t st;
};

template <typename... KArgs, typename... Args>
static void launch_pass(void (*kernel)(KArgs...), unsigned blocks, unsigned threads,
                        size_t smem, cudaStream_t st, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, kernel, KArgs(args)...);
}

template <int L, bool INV>
static void launch_col(const u64 *src, u64 *dst, const PassArgs &a) {
    int logc = a.logn2 < COL_LOGC ? a.logn2 : COL_LOGC;
    if (logc > COL_MAX_LOG_THREADS - (L - GROUP_LOG)) logc = COL_MAX_LOG_THREADS - (L - GROUP_LOG);
    const unsigned blocks = (unsigned)(a.nslab << (a.logn2 - logc));
    launch_pass(ntt_col_pass<L, INV>, blocks, 1u << (logc + L - GROUP_LOG),
                sizeof(word) << (logc + L), a.st,
                src, dst, a.dim, a.logn2, logc, a.tw, a.primes, a.scale, a.scale_s);
}

template <int L, bool INV>
static void launch_row(const u64 *src, u64 *dst, const PassArgs &a, int finish) {
    const long long nseq = a.nslab << a.logn1;
    const int S = ROW_THREADS >> (L - GROUP_LOG);
    launch_pass(ntt_row_pass<L, INV>, (unsigned)((nseq + S - 1) / S), ROW_THREADS, 0, a.st,
                src, dst, nseq, a.dim, a.logn1, a.tw, a.primes, a.scale, a.scale_s, finish);
}

template <bool INV>
static void col_pass(const u64 *src, u64 *dst, const PassArgs &a) {
    switch (a.logn1) {
        case 5: launch_col<5, INV>(src, dst, a); break;
        case 6: launch_col<6, INV>(src, dst, a); break;
        case 7: launch_col<7, INV>(src, dst, a); break;
        case 8: launch_col<8, INV>(src, dst, a); break;
    }
}

template <bool INV>
static void row_pass(const u64 *src, u64 *dst, const PassArgs &a, int finish) {
    switch (a.logn2) {
        case 4: launch_row<4, INV>(src, dst, a, finish); break;
        case 5: launch_row<5, INV>(src, dst, a, finish); break;
        case 6: launch_row<6, INV>(src, dst, a, finish); break;
        case 7: launch_row<7, INV>(src, dst, a, finish); break;
        case 8: launch_row<8, INV>(src, dst, a, finish); break;
    }
}

// One transform of [nslab, n] residues, slab j on prime j % dim; tw is the
// [dim, n] table of (z, companion) pairs, forward or inverse.  4 <= logn <= 16.
// Two launches (one for n <= 2^8) on the stream; allocates nothing, does
// not synchronise.
static int ntt_two_pass(const u64 *in, u64 *out, long long nslab, int dim, int logn,
                        const wpair *tw, const word *primes, const word *scale,
                        const word *scale_s, int inverse, cudaStream_t st) {
    if (logn < 4 || logn > 16) return (int)cudaErrorInvalidValue;
    const int logn1 = logn <= ONE_PASS_MAX_LOGN ? 0 : (logn + 1) / 2;
    const PassArgs a = {nslab, dim, logn1, logn - logn1, tw, primes, scale, scale_s, st};
    if (!inverse) {
        if (logn1) col_pass<false>(in, out, a);
        row_pass<false>(logn1 ? out : in, out, a, 1);
    } else {
        row_pass<true>(in, out, a, !logn1);
        if (logn1) col_pass<true>(out, out, a);
    }
    return (int)cudaGetLastError();
}
