"""csrc/ntt_passes.cuh in numpy, for the CPU tests of both CUDA NTT kernels
(test_torch_ntt.py: Python ints for u64 words; test_torch_ntt32.py: numpy
uint32 words).

schedule_model() walks the two-pass schedule block by block and thread by
thread through the index maps of gpqhe_tpu_torch.ops.ntt_cuda, which the
kernels follow (split, register groups, thread -> elements, stage -> twiddle
index into the interleaved table, shared-memory layout), with the arithmetic
the caller supplies; pass_geometry() is the kernels' launch geometry.  The
tile sizes below mirror the constants of the .cuh and the two .cu files.
Imports neither jax nor the JAX package.
"""

import numpy as np

from gpqhe_tpu_torch.ops.ntt_cuda import (GROUP_LOG, col_smem_index, element_index,
                                          group_windows, row_smem_index, split_logn,
                                          twiddle_index)

ROW_THREADS = 128             # threads of a row-pass block
COL_MAX_THREADS = 512         # most threads of a column-pass block
COL_LOGC = {64: 3, 32: 4}     # columns of a column tile: 64 B of words a row


def pass_geometry(logn: int, nslab: int, word: int, split=None) -> list[dict]:
    """The launches of one forward transform, in order (the inverse runs them
    in the opposite order): per pass its kind, log2 size L, sequences per
    block, threads, blocks and shared-memory words."""
    logn1, logn2 = split_logn(logn) if split is None else split
    out = []
    if logn1:
        logc = min(logn2, COL_LOGC[word],
                   COL_MAX_THREADS.bit_length() - 1 - (logn1 - GROUP_LOG))
        out.append({"kind": "col", "L": logn1, "seqs": 1 << logc,
                    "threads": 1 << (logc + logn1 - GROUP_LOG),
                    "blocks": nslab << (logn2 - logc), "smem_words": 1 << (logc + logn1)})
    s = max(1, ROW_THREADS >> (logn2 - GROUP_LOG))
    out.append({"kind": "row", "L": logn2, "seqs": s, "threads": s << (logn2 - GROUP_LOG),
                "blocks": -(-(nslab << logn1) // s),
                "smem_words": s * ((1 << logn2) + (1 << (logn2 - GROUP_LOG)))})
    return out


def _exchange(x, t, a_from, a_to, addr, smem_words):
    """Registers at window a_from -> a model shared memory at addr(idx), where
    no two registers of the block may meet -> registers at window a_to."""
    sm = np.empty(smem_words, dtype=x.dtype)
    wr = np.stack([addr(element_index(t, e, a_from)) for e in range(8)], 1)
    assert len(np.unique(wr)) == wr.size and wr.max() < smem_words
    sm[wr] = x
    return sm[np.stack([addr(element_index(t, e, a_to)) for e in range(8)], 1)]


def _run_groups(x, L, inverse, groups, t, tw, d, base, p, arith, addr, smem_words):
    """The register groups of one block: x[threads, 8] on the pairs
    tw[d, index], with an exchange between groups."""
    wins = group_windows(L, groups)
    if inverse:
        wins = wins[::-1]
    prev = None
    for lo, w, a in wins:
        if prev is not None:
            x = _exchange(x, t, prev, a, addr, smem_words)
        prev = a
        bits = range(lo - a, lo - a + w)
        for b in (bits if inverse else reversed(bits)):
            for e0 in range(8):
                if e0 >> b & 1:
                    continue
                z = tw[d, twiddle_index(base, L, a, b, t, e0)]
                bf = arith.inv_bf if inverse else arith.fwd_bf
                x[:, e0], x[:, e0 | 1 << b] = bf(x[:, e0], x[:, e0 | 1 << b],
                                                 z[:, 0], z[:, 1], p)
    return x


def schedule_model(a, tw, primes, scale, mode: str, arith, *, split=None,
                   col_seqs=None, row_seqs=None, groups=None, word: int = 64):
    """a is [nslab, n] words as they lie in device memory (slab j on prime
    j % dim), tw [dim, n, 2], primes [dim], scale [2, dim].  arith supplies
    load (narrowing), fwd_bf, inv_bf, scale_reduce and final_reduce on arrays
    and checks its own bounds.  The keyword arguments override the kernel's
    split, tile sizes (sequences per block) and stage groups ({L: widths});
    returns the output words."""
    nslab, n = a.shape
    logn = n.bit_length() - 1
    dim = len(primes)
    logn1, logn2 = split_logn(logn) if split is None else split
    assert logn1 + logn2 == logn
    n1, n2 = 1 << logn1, 1 << logn2
    inverse = mode != "fwd"
    geo = {g["kind"]: g for g in pass_geometry(logn, nslab, word, (logn1, logn2))}
    groups = groups or {}

    def windows(L):
        """Window bit of the pass's first and of its last group."""
        wins = group_windows(L, groups.get(L))
        return (wins[-1][2], wins[0][2]) if inverse else (wins[0][2], wins[-1][2])

    def col_pass(src, dst):
        L, C = logn1, col_seqs or geo["col"]["seqs"]
        tid = np.arange(C << (L - GROUP_LOG))
        j, t = tid % C, tid // C
        a0, a1 = windows(L)
        for blk in range(nslab * n2 // C):
            slab, c0 = divmod(blk, n2 // C)
            d = slab % dim
            g0 = slab * n + c0 * C + j
            x = np.stack([arith.load(src[g0 + element_index(t, e, a0) * n2])
                          for e in range(8)], 1)
            x = _run_groups(x, L, inverse, groups.get(L), t, tw, d, 1, primes[d], arith,
                            lambda idx: col_smem_index(j, idx, C), C << L)
            if inverse:
                x = arith.scale_reduce(x, scale[0][d], scale[1][d], primes[d])
            for e in range(8):
                dst[g0 + element_index(t, e, a1) * n2] = x[:, e]

    def row_pass(src, dst, finish):
        L, S = logn2, row_seqs or geo["row"]["seqs"]
        tid = np.arange(S << (L - GROUP_LOG))
        s, t = tid >> (L - GROUP_LOG), tid & ((1 << (L - GROUP_LOG)) - 1)
        a0, a1 = windows(L)
        nseq = nslab * n1
        smem_words = S * ((1 << L) + (1 << (L - GROUP_LOG)))

        def addr(idx):
            return row_smem_index(s, idx, L)
        for blk in range(-(-nseq // S)):
            q = blk * S + s
            active = q < nseq
            qc = np.minimum(q, nseq - 1)      # idle threads repeat the last sequence
            d = (qc >> logn1) % dim           # a block may span slabs: per thread
            p = primes[d]
            x = np.stack([arith.load(src[qc * n2 + element_index(t, e, a0)])
                          for e in range(8)], 1)
            x = _run_groups(x, L, inverse, groups.get(L), t, tw, d, n1 + (qc & (n1 - 1)),
                            p, arith, addr, smem_words)
            if finish and inverse:
                x = arith.scale_reduce(x, scale[0][d][:, None], scale[1][d][:, None],
                                       p[:, None])
            elif finish:
                x = arith.final_reduce(x, p[:, None])
            a_out = a1
            if a1 == 0:                       # contiguous registers -> strided ones
                a_out = L - GROUP_LOG
                x = _exchange(x, t, 0, a_out, addr, smem_words)
            for e in range(8):
                dst[(qc * n2 + element_index(t, e, a_out))[active]] = x[active, e]

    src = a.reshape(-1)
    out = np.zeros_like(src)
    if not inverse:
        if logn1:
            col_pass(src, out)
            src = out
        row_pass(src, out, True)
    else:
        row_pass(src, out, not logn1)
        if logn1:
            col_pass(out, out)
    return out.reshape(nslab, n)
