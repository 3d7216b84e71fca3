// The row kernels' shared parts, for the kernels that carry through a row
// of u32 limbs: the limb chains of limbs.cu and the CRT lift of rns.cu, for
// Hopper (sm_90a).  One design: a warp per row group, reading and writing
// neighbouring words across the warp.
//
// The lanes of a warp are 32 / W groups of W lanes, one row a group: lane i
// of a group holds limb i of its row, W = L + 1 for rows of L < 32 limbs, so
// that a lane with no limb between two groups stops every carry.  A row of
// L >= 32 limbs takes the whole warp (W = 32, one group) and is walked 32
// limbs at a time, a chunk: lane i holds limb c0 + i of chunk c0, and the
// carry, borrow or comparison out of lane 31 goes into the next chunk's
// lane 0.  Loads and stores are coalesced (a group's limbs are consecutive
// words of a row-contiguous operand, its groups consecutive rows), each lane
// takes WARP_GROUPS rows, all loaded before any is worked, and no warp waits
// on another: no shared memory, no barrier.  A chunk's carries are those of
// one 32-bit sum of two ballots (lane_chain).  (A block's rows staged
// through shared memory, one thread walking one row there, ran 1.3-1.6x
// slower than this at 14 limbs; PERF.md.)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef long long i64;

#define ROWWARP_THREADS 128    // threads of a block
#define WARP_GROUPS 4      // rows a lane takes, loaded before any is worked
#define M32 0xFFFFFFFFull

// n / d for n < 2^31 by a multiply and a shift (the magic numbers of
// torch's IntDivider), set up on the host: a division by a runtime value is
// some 20 instructions, and a 64-bit one a subroutine call with a stack
// frame.
struct FastDiv {
    unsigned d, m, s;
    static FastDiv of(unsigned d) {
        unsigned s = 0;
        while (s < 32 && (1ull << s) < d) ++s;
        return {d, (unsigned)((((1ull << 32) * ((1ull << s) - d)) / d) + 1), s};
    }
    __device__ __forceinline__ unsigned div(unsigned n) const {
        return (__umulhi(n, m) + n) >> s;
    }
};

struct LaneGroups {
    int W, G, grp, i;
    unsigned base;         // the group's first lane
    __device__ __forceinline__ explicit LaneGroups(int L) {
        W = L < 32 ? L + 1 : 32;
        G = 32 / W;
        const int lane = threadIdx.x & 31;
        grp = lane / W;
        i = lane - grp * W;
        base = grp * W;
    }
    // the lanes of this lane's group
    __device__ __forceinline__ unsigned mask() const {
        return (W >= 32 ? ~0u : (1u << W) - 1) << base;
    }
};

// The rows a block of ROWWARP_THREADS takes for rows of L limbs, rows_a_lane
// rows a lane.
__host__ __forceinline__ unsigned rows_a_block(int L, int rows_a_lane) {
    return ROWWARP_THREADS / 32 * rows_a_lane * (32 / (L < 32 ? L + 1 : 32));
}

// The carry (or borrow) into this lane of a chain of 0/1 carries, from each
// lane's generate and propagate bits and c, the carry into its group's
// first lane: the carries of the sum of the masks X = G | P and Y = G, read
// off as (X + Y + C) ^ X ^ Y.  A lane with neither bit stops the chain.  c
// becomes the carry out of lane 31, which goes into the next chunk of a
// row that takes the warp.  Every lane of the warp calls it.
__device__ __forceinline__ u64 lane_chain(const LaneGroups &lg, bool gen, bool prop, u64 &c) {
    const unsigned X = __ballot_sync(~0u, gen || prop), Y = __ballot_sync(~0u, gen),
                   C = __ballot_sync(~0u, lg.i == 0 && c);
    const u64 s = (u64)X + Y + C;
    c = s >> 32;
    return (s ^ X ^ Y) >> (threadIdx.x & 31) & 1;
}

// x >= c over a row, one chunk at a time from the highest: the highest limb
// where they differ decides, so the first chunk with a difference sets `ge`
// and `done` (ge starts true: equal counts as >=).  `limb` marks the lanes
// of the chunk's limbs.  Every lane calls it.
__device__ __forceinline__ void lane_geq(const LaneGroups &lg, bool limb, u64 x, u64 c, bool &ge,
                                         bool &done) {
    const unsigned ne = __ballot_sync(~0u, limb && x != c) & lg.mask(),
                   gt = __ballot_sync(~0u, limb && x > c);
    if (!done && ne) {
        ge = gt >> (31 - __clz(ne)) & 1;
        done = true;
    }
}

// x + y and x - y over each group's limbs (mod 2^(32 k)), limbs below 2^32,
// with the carry or borrow c into the chunk (then out of it).  Every lane
// calls them.
__device__ __forceinline__ u64 lane_add(const LaneGroups &lg, bool limb, u64 x, u64 y, u64 &c) {
    const u64 s = x + y;
    return (s + lane_chain(lg, limb && (s >> 32), limb && (s & M32) == M32, c)) & M32;
}

__device__ __forceinline__ u64 lane_sub(const LaneGroups &lg, bool limb, u64 x, u64 y, u64 &c) {
    return (x - y - lane_chain(lg, limb && x < y, limb && x == y, c)) & M32;
}

// The carries a chunk of lane_digits passes to the next: the high part of
// lane 31 before each of the two moves, and the chain's carry.
struct DigitCarry {
    u64 h1, h2, c;
};

// lo + hi 2^32 per lane, hi moved up a lane (a group's first lane takes h;
// then, where the row goes on in a next chunk, h becomes lane 31's hi): the
// same sum over the group's limbs.
__device__ __forceinline__ void lane_up(const LaneGroups &lg, u64 &lo, u64 &hi, u64 &h,
                                        bool chunked) {
    const u64 up = __shfl_up_sync(~0u, hi, 1);
    const u64 v = lo + (lg.i ? up : h);
    if (chunked) h = __shfl_sync(~0u, hi, 31);
    lo = v & M32;
    hi = v >> 32;
}

// The 16-bit digits d0 = digit 2i and d1 = digit 2i + 1 of each group's row
// (sums below 2^63) into limb i of sum_j d_j 2^(16 j) mod 2^(32 k), `limb`
// marking the lanes of the k limbs: d0 + d1 2^16 = lo + hi 2^32, then twice
// hi moves up a lane (hi < 2^48, then < 2^16 + 1, then 0 or 1; a chunk's
// lane 0 takes lane 31's of the chunk before), then one chain.  `chunked`
// (warp-uniform): the row goes on in a next chunk.
__device__ __forceinline__ u64 lane_digits(const LaneGroups &lg, bool limb, u64 d0, u64 d1,
                                           DigitCarry &dc, bool chunked) {
    const u64 t = (d0 & M32) + ((d1 & 0xFFFF) << 16);
    u64 lo = t & M32, hi = (t >> 32) + (d0 >> 32) + (d1 >> 16);
    lane_up(lg, lo, hi, dc.h1, chunked);
    lane_up(lg, lo, hi, dc.h2, chunked);
    return (lo + lane_chain(lg, limb && hi, limb && lo == M32, dc.c)) & M32;
}
