/* Native host substrate: surf CSPRNG + Keccak-f[1600] sponge.
 *
 * These are the components the reference implements in C (rng.c fips202.c);
 * here they back the Python substrate via ctypes when available (the numpy
 * implementations remain as the portable fallback and as the KAT oracle).
 *
 * Written from the published algorithms (DJB's surf; FIPS-202), not copied.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* surf (SUPERCOP deterministic randombytes)                           */
/* ------------------------------------------------------------------ */

#define ROTATE(x, b) (((x) << (b)) | ((x) >> (32 - (b))))

static void surf_one(const uint32_t seed[32], const uint32_t in[12], uint32_t out[8])
{
    uint32_t t[12], x, sum = 0;
    int r, i, loop;
    static const int shifts[12] = {5, 7, 9, 13, 5, 7, 9, 13, 5, 7, 9, 13};
    for (i = 0; i < 12; ++i) t[i] = in[i] ^ seed[12 + i];
    for (i = 0; i < 8; ++i) out[i] = seed[24 + i];
    x = t[11];
    for (loop = 0; loop < 2; ++loop) {
        for (r = 0; r < 16; ++r) {
            sum += 0x9e3779b9;
            for (i = 0; i < 12; ++i) {
                x = t[i] += (((x ^ seed[i]) + sum) ^ ROTATE(x, shifts[i]));
            }
        }
        for (i = 0; i < 8; ++i) out[i] ^= t[i + 4];
    }
}

/* Width-W batched surf: W independent counters march through the identical
 * round schedule, laid out as t[i][W] so the per-round update is a W-lane
 * elementwise op the compiler auto-vectorizes (SSE/AVX).  Bit-exact vs
 * surf_one — blocks are independent by construction. */
#define SURF_W 32
typedef uint32_t surf_vec __attribute__((vector_size(SURF_W * 4)));

static inline surf_vec surf_splat(uint32_t v)
{
    surf_vec r;
    for (int w = 0; w < SURF_W; ++w) r[w] = v;
    return r;
}

static void surf_batch(const uint32_t seed[32], uint64_t ctr0,
                       uint8_t *stream)
{
    surf_vec t[12], out[8], x;
    uint32_t sum = 0;
    int r, i, w, loop;
    static const int shifts[12] = {5, 7, 9, 13, 5, 7, 9, 13, 5, 7, 9, 13};
    for (w = 0; w < SURF_W; ++w) {
        uint64_t ctr = ctr0 + (uint64_t)w;
        t[0][w] = ((uint32_t)(ctr & 0xffffffffu)) ^ seed[12];
        t[1][w] = ((uint32_t)(ctr >> 32)) ^ seed[13];
    }
    for (i = 2; i < 12; ++i) t[i] = surf_splat(seed[12 + i]);
    for (i = 0; i < 8; ++i) out[i] = surf_splat(seed[24 + i]);
    x = t[11];
    for (loop = 0; loop < 2; ++loop) {
        for (r = 0; r < 16; ++r) {
            sum += 0x9e3779b9;
            for (i = 0; i < 12; ++i) {
                const surf_vec si = surf_splat(seed[i]);
                const surf_vec sv = surf_splat(sum);
                const int sh = shifts[i];
                surf_vec rot = (x << sh) | (x >> (32 - sh));
                x = t[i] = t[i] + ((((x ^ si) + sv) ^ rot));
            }
        }
        for (i = 0; i < 8; ++i) out[i] ^= t[i + 4];
    }
    for (w = 0; w < SURF_W; ++w)
        for (i = 0; i < 8; ++i)
            stream[w * 8 + i] = (uint8_t)(out[7 - i][w] & 0xff);
}

/* Generate nblocks surf outputs for counters start+1 .. start+nblocks,
 * 8 stream bytes per block in consumption order (out[7]&0xff first). */
void gpqhe_surf_blocks(const uint32_t seed[32], uint64_t start,
                       uint64_t nblocks, uint8_t *stream)
{
    uint32_t in[12];
    uint32_t out[8];
    uint64_t b = 0;
    memset(in, 0, sizeof(in));
    for (; b + SURF_W <= nblocks; b += SURF_W)
        surf_batch(seed, start + 1 + b, stream + b * 8);
    for (; b < nblocks; b++) {
        uint64_t ctr = start + 1 + b;
        in[0] = (uint32_t)(ctr & 0xffffffffu);
        in[1] = (uint32_t)(ctr >> 32);
        in[2] = 0; in[3] = 0;
        surf_one(seed, in, out);
        for (int i = 0; i < 8; i++)
            stream[b * 8 + i] = (uint8_t)(out[7 - i] & 0xff);
    }
}

/* ------------------------------------------------------------------ */
/* Keccak-f[1600] + sponge                                             */
/* ------------------------------------------------------------------ */

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int RHO[25] = {
    0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39,
    41, 45, 15, 21, 8, 18, 2, 61, 56, 14};

#define ROL64(a, n) (((a) << (n)) | ((a) >> (64 - (n))))

void gpqhe_keccak_f1600(uint64_t a[25])
{
    uint64_t b[25], c[5], d[5];
    for (int rnd = 0; rnd < 24; rnd++) {
        for (int x = 0; x < 5; x++)
            c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
        for (int x = 0; x < 5; x++)
            d[x] = c[(x + 4) % 5] ^ ROL64(c[(x + 1) % 5], 1);
        for (int y = 0; y < 5; y++)
            for (int x = 0; x < 5; x++)
                a[x + 5 * y] ^= d[x];
        /* rho + pi: b[y, 2x+3y] = rol(a[x, y]) with lane index x+5y */
        for (int y = 0; y < 5; y++)
            for (int x = 0; x < 5; x++) {
                int r = RHO[x + 5 * y];
                b[y + 5 * ((2 * x + 3 * y) % 5)] = r ? ROL64(a[x + 5 * y], r)
                                                     : a[x + 5 * y];
            }
        for (int y = 0; y < 5; y++)
            for (int x = 0; x < 5; x++)
                a[x + 5 * y] = b[x + 5 * y] ^
                    ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
        a[0] ^= RC[rnd];
    }
}

/* One-shot sponge: absorb in, pad with suffix, squeeze outlen bytes. */
void gpqhe_shake(int rate, uint8_t suffix, const uint8_t *in, size_t inlen,
                 uint8_t *out, size_t outlen)
{
    uint64_t st[25];
    uint8_t *sb = (uint8_t *)st;
    memset(st, 0, sizeof(st));
    while (inlen >= (size_t)rate) {
        for (int i = 0; i < rate; i++) sb[i] ^= in[i];
        gpqhe_keccak_f1600(st);
        in += rate;
        inlen -= rate;
    }
    for (size_t i = 0; i < inlen; i++) sb[i] ^= in[i];
    sb[inlen] ^= suffix;
    sb[rate - 1] ^= 0x80;
    while (outlen > 0) {
        gpqhe_keccak_f1600(st);
        size_t take = outlen < (size_t)rate ? outlen : (size_t)rate;
        memcpy(out, sb, take);
        out += take;
        outlen -= take;
    }
}
