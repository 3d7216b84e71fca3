// u8 products on the tensor cores by mma.sync, and the shared-memory moves
// that feed them, for the kernels that take a modular or CRT product in byte
// planes: K8's stage (ntt4.cu) and the CRT reconstruct's digit product
// (rns.cu).

#pragma once

#include <cuda_runtime.h>

typedef unsigned int u32;
typedef unsigned char u8;

__device__ __forceinline__ u32 smem_addr(const void *p) {
    return static_cast<u32>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(u32 dst, const void *src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// NB (4 or 8) bytes from global to shared memory, zeros where !in
template <int NB>
__device__ __forceinline__ void cp_async_zfill(u32 dst, const void *src, bool in) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(NB),
                 "r"(in ? NB : 0));
}

__device__ __forceinline__ void ldsm_x4(u32 (&r)[4], u32 addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// d += a b for a [16 x 32] u8 (row), b [32 x 8] u8 (col), d [16 x 8] s32
__device__ __forceinline__ void mma_u8(int (&d)[4], const u32 (&a)[4], u32 b0, u32 b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
