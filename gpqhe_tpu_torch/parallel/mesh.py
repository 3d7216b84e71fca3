"""Multi-device parallelism: (limb[, coeff], batch) meshes of torch devices
for the RNS pipeline.

Port of gpqhe_tpu/parallel/mesh.py.  The reference exposes four natural
parallel axes but implements none (SURVEY.md §2: pthread code compiled out,
ref: src/rns.c:79-216).  Here they are the axes of a mesh of devices:

  limb  — the per-prime d-loop of every heavy op (ref: src/poly.c:94-102):
          decompose / NTT / pointwise / INTT are embarrassingly parallel per
          prime; only the CRT reconstruction needs a sum over this axis
          (digit partial sums — rns.reconstruct_sharded).
  coeff — the polynomial-coefficient axis (the reference's n-loops,
          ref: src/ntt.c:42-51): the long-sequence analogue.  The NTT's
          first log2(S) stages pair whole shards (one block swap per stage);
          all remaining stages are shard-local and run the NTT kernel at
          length n/S on per-shard tables (ntt_cuda.ShardTables).
  batch — independent ciphertexts (pure data parallelism).

Where JAX's shard_map runs a per-shard body over global arrays, the
programs here keep one local tensor per mesh position in a dict keyed by the
position (j, s, b) and walk the positions in a Python loop, step by step.  A
mesh is an array of torch devices that may name one device several times (a
virtual mesh: the role of XLA's forced host device count in the JAX tests);
the same code drives distinct devices, where the collectives become copies
between them.  A mesh may also span processes (make_he_mesh3(..., group=),
the counterpart of a jax.distributed mesh): each process walks only its own
positions, and data crosses processes as torch.distributed messages
(parallel/dist.py).  Data crosses positions in three functions only —
_psum_limb, _ppermute_coeff_xor and _gather (a _scatter cuts the global
input, which every process holds) — all through _transfer.  Every program
takes ordinary tensors and returns them on this process's first device.

As the JAX package compiles each of its five sharded programs once (tpu_jit
around shard_map), a mesh whose positions all lie on one device of this
process, with no process group (HeMesh.graphable: a virtual mesh), runs
each program as one CUDA graph per argument shapes (utils/graphs.py): the
walk over positions, its collectives included, is captured once and
replayed with one dispatch.  A mesh over several devices or processes runs
its programs eagerly, by that rule, fixed when the mesh is made.

Collectives per program: log2(S) block swaps per NTT on 'coeff'; one sum of
[batch, n/S, ds] digit partials (and an [batch, n/S] f64 estimate) per CRT
reconstruct on 'limb'.
"""

from __future__ import annotations

import itertools
import weakref

import numpy as np
import torch

from ..context import PolyContext
from ..ops import cuda_build, ntt_cuda, ntt_cuda32
from ..ops import limbs as lb
from ..ops import rns as rns_ops
from ..ops.modmath import (addmod, cross_terms, key_products, mont_mul, mulmod, mulmod_sum,
                           submod, u64_to_torch)
from ..ring.poly import ntt_module
from ..utils import graphs
from . import dist as pdist

_AXES = ("limb", "coeff", "batch")
_COLLECTIVES = ("psum", "ppermute", "scatter", "gather")
_KINDS = ("view", "device", "process")

# What the collectives of every live mesh moved: {(mesh serial, collective,
# kind, 0 for transfers or 1 for bytes): count}.  Flat, and registered with
# the launch counters, so that a graph's replay adds again what its capture
# counted (utils/graphs.py): a replay runs none of the Python that counts.
TRAFFIC = cuda_build.counters({})
_SERIALS = itertools.count()


def _forget_traffic(serial: int) -> None:
    for key in [k for k in TRAFFIC if k[0] == serial]:
        del TRAFFIC[key]


class HeMesh:
    """An array of torch devices with named axes, (limb, batch) or
    (limb, coeff, batch); .shape maps axis name -> size as jax's Mesh does.

    ranks (same shape as devices) names the process that holds each
    position, rank is this process and group the torch.distributed group
    that joins them (None: one process holds every position).
    local_positions are the positions this process walks.

    traffic_by_kind counts what the collectives moved into this process's
    positions since reset_traffic(): {collective: {kind: [transfers,
    bytes]}}, kind "view" (both positions on one device: no copy), "device"
    (a copy between two devices of this process) or "process" (a message
    from another process); "staged" counts the bytes this process copied
    between a card and host memory for messages over a gloo group.
    traffic is {collective: [transfers, bytes]} over the three kinds.

    graphable: one process holds every position and they all lie on one
    device, so that the sharded programs run as graphs (the module's
    docstring); else eager_why says why they run eagerly.  graphs holds
    the graphs of the programs that no engine owns (the poly_mul
    builders), one memory pool per device."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...],
                 ranks: np.ndarray | None = None, rank: int = 0, group=None):
        if devices.ndim != len(axis_names) or not set(axis_names) <= set(_AXES):
            raise ValueError(f"mesh axes {axis_names} do not fit devices {devices.shape}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, devices.shape))
        # positions are (limb, coeff, batch) triples: a mesh without a
        # coefficient axis has one coefficient shard
        grid_shape = tuple(self.shape.get(a, 1) for a in _AXES)
        self._grid = devices.reshape(grid_shape)
        self.positions = [tuple(int(i) for i in pos) for pos in np.ndindex(grid_shape)]
        self._ranks = (np.zeros(grid_shape, dtype=np.int64) if ranks is None
                       else np.asarray(ranks).reshape(grid_shape))
        self.rank, self.group = rank, group
        self.local_positions = [p for p in self.positions if self.rank_of(p) == rank]
        if not self.local_positions:
            raise ValueError(f"rank {rank} holds no position of the mesh")
        # each rank's first position: where a gather leaves the whole output
        self.rank_heads = [next(p for p in self.positions if self.rank_of(p) == r)
                           for r in range(int(self._ranks.max()) + 1)]
        self._ring_tables: dict = {}
        self._serial = next(_SERIALS)
        weakref.finalize(self, _forget_traffic, self._serial)
        self.reset_traffic()
        devs = sorted({str(self.device(p)) for p in self.local_positions})
        self.eager_why = (
            "the mesh spans processes: a CUDA graph does not capture their messages"
            if group is not None else
            f"positions on {len(devs)} devices ({', '.join(devs)}): a CUDA graph holds "
            f"the work of one device" if len(devs) > 1 else None)
        self.graphable = self.eager_why is None
        self.graphs = graphs.Graphs()

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def device(self, pos) -> torch.device:
        return self._grid[pos]

    def rank_of(self, pos) -> int:
        return int(self._ranks[pos])

    @property
    def first_device(self) -> torch.device:
        """This process's first device: the engine's, and where every
        program leaves its output."""
        return self.device(self.local_positions[0])

    def reset_traffic(self) -> None:
        for c in _COLLECTIVES:
            for k in _KINDS + ("staged",):
                TRAFFIC[self._serial, c, k, 0] = TRAFFIC[self._serial, c, k, 1] = 0

    @property
    def traffic_by_kind(self) -> dict[str, dict[str, list[int]]]:
        s = self._serial
        return {c: {k: [TRAFFIC[s, c, k, 0], TRAFFIC[s, c, k, 1]] for k in _KINDS + ("staged",)}
                for c in _COLLECTIVES}

    @property
    def traffic(self) -> dict[str, list[int]]:
        return {c: [sum(kinds[k][i] for k in _KINDS) for i in (0, 1)]
                for c, kinds in self.traffic_by_kind.items()}


def _mesh_devices(n_devices: int | None, devices) -> list:
    """The first n_devices of `devices`, or of the visible CUDA devices.
    Never the CPU and never a repeated device unless the caller lists it.
    A CUDA device without an index is the current one."""
    if devices is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in devs]
    if n_devices is None:
        n_devices = len(devs)
    if n_devices < 1 or len(devs) < n_devices:
        raise RuntimeError(
            f"the mesh needs {n_devices} devices; "
            + (f"devices= lists {len(devs)}" if devices is not None else
               f"this machine has {len(devs)} CUDA devices (pass devices=, a list that "
               f"may repeat a device, for a virtual mesh)"))
    return devs[:n_devices]


def _device_array(devs, shape) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr.reshape(shape)


def make_he_mesh(n_devices: int | None = None, limb: int | None = None,
                 devices=None) -> HeMesh:
    """Create a (limb, batch) mesh over the visible CUDA devices, or over
    `devices` (see make_he_mesh3)."""
    devs = _mesh_devices(n_devices, devices)
    n_devices = len(devs)
    if limb is None:
        limb = n_devices
        batch = 1
        while limb > 4 and limb % 2 == 0:
            limb //= 2
            batch *= 2
    else:
        batch = n_devices // limb
    if limb * batch != n_devices:
        raise ValueError(f"{n_devices} devices do not fill a mesh with limb={limb}")
    return HeMesh(_device_array(devs, (limb, batch)), ("limb", "batch"))


def make_he_mesh3(n_devices: int | None = None, limb: int = 1,
                  coeff: int = 1, devices=None, group=None) -> HeMesh:
    """Create a (limb, coeff, batch) mesh.

    devices: explicit device list (defaults to the visible CUDA devices;
    raises where there are fewer than n_devices).  A list that repeats a
    device, e.g. [torch.device("cuda:0")] * 8, makes a virtual mesh on it:
    every program runs the same per-shard steps, and the collectives are
    views and adds instead of copies.

    group: a torch.distributed group (parallel/dist.py).  Then devices are
    this process's own, every member of the group calls this with the same
    arguments, and the mesh is every rank's devices in rank order, n_devices
    of them in all: with limb the slowest axis, the limb axis crosses
    processes first.  Each rank walks its own positions only."""
    if group is None:
        devs = _mesh_devices(n_devices, devices)
        ranks, rank = None, 0
    else:
        lists = pdist.gather_device_lists(group, _mesh_devices(None, devices))
        devs = [torch.device(d) for lst in lists for d in lst]
        ranks = np.array([r for r, lst in enumerate(lists) for _ in lst])
        rank = torch.distributed.get_rank(group)
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"the group's ranks hold {len(devs)} devices, not {n_devices}")
    n_devices = len(devs)
    batch = n_devices // (limb * coeff)
    if limb * coeff * batch != n_devices:
        raise ValueError(f"{n_devices} devices do not fill a mesh with limb={limb}, "
                         f"coeff={coeff}")
    shape = (limb, coeff, batch)
    return HeMesh(_device_array(devs, shape), _AXES,
                  None if ranks is None else ranks.reshape(shape), rank, group)


# ---------------------------------------------------------------------------
# sharded values and the three collectives
# ---------------------------------------------------------------------------
# A sharded value is a dict {position: local tensor} over this process's
# positions; per-shard constants are a dict {position: {name: tensor or
# plan}}.  Every block of a sharded value has one shape and dtype.

def _each(fn, *parts) -> dict:
    """fn at every mesh position on that position's local parts."""
    return {pos: fn(*(p[pos] for p in parts)) for pos in parts[0]}


def _merge(*consts) -> dict:
    """Per-shard constant dicts joined name-wise."""
    return {pos: {k: v for c in consts for k, v in c[pos].items()} for pos in consts[0]}


def _count(mesh: HeMesh, collective: str, kind: str, t: torch.Tensor) -> None:
    TRAFFIC[mesh._serial, collective, kind, 0] += 1
    TRAFFIC[mesh._serial, collective, kind, 1] += t.numel() * t.element_size()


def _move(mesh: HeMesh, t: torch.Tensor, pos, collective: str) -> torch.Tensor:
    """t on the device of this process's position pos, counted as one
    transfer: a view where t is there already, else a copy."""
    dev = mesh.device(pos)
    _count(mesh, collective, "view" if t.device == dev else "device", t)
    return t.to(dev)


def _transfer(mesh: HeMesh, values: dict, moves, collective: str, like: torch.Tensor) -> dict:
    """values[src] on the device of dst, for every (src, dst) of moves whose
    dst this process holds: {(src, dst): tensor}.  moves is one global list,
    built alike on every rank.  Between two positions of this process it is
    a _move; across processes one message a move, a step's messages posted
    together (dist.schedule / dist.exchange).  like: a block of the value
    (every block has its shape and dtype), the shape of a receive buffer.
    On a gloo group a CUDA block crosses through host memory."""
    stage = mesh.group is not None and pdist.stages_through_host(mesh.group)
    out, ops, landed = {}, [], []
    for op, peer, (src, dst) in pdist.schedule(mesh.rank_of, moves, mesh.rank):
        if op == "local":
            out[src, dst] = _move(mesh, values[src], dst, collective)
        elif op == "send":
            t = values[src]
            if t.shape != like.shape or t.dtype != like.dtype:
                raise ValueError(f"block {tuple(t.shape)} {t.dtype} of {src} is not the "
                                 f"value's {tuple(like.shape)} {like.dtype}")
            if t.is_cuda and stage:
                _count(mesh, collective, "staged", t)
                t = t.cpu()
            elif not t.is_cuda and not stage:
                raise ValueError(f"position {src} is on {t.device}: an nccl group sends "
                                 f"CUDA tensors only")
            ops.append((op, peer, t.contiguous()))
        else:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if stage else mesh.device(dst))
            ops.append((op, peer, buf))
            landed.append((src, dst, buf))
    pdist.exchange(mesh.group, ops)
    for src, dst, buf in landed:
        dev = mesh.device(dst)
        _count(mesh, collective, "process", buf)
        if buf.device != dev:
            _count(mesh, collective, "staged", buf)
        out[src, dst] = buf.to(dev)
    return out


def _first_block(parts: dict) -> torch.Tensor:
    return next(iter(parts.values()))


def _psum_limb(mesh: HeMesh, parts: dict) -> dict:
    """Limb psum: add the per-shard partials of every (coeff, batch) column
    and give each member of the column the sum.  The members send to the
    column's head (limb index 0), which adds them in limb order and sends
    the total back: one order of addition whatever the layout."""
    like = _first_block(parts)
    heads = [pos for pos in mesh.positions if pos[0] == 0]
    pairs = [((j,) + h[1:], h) for h in heads for j in range(1, mesh.size("limb"))]
    got = _transfer(mesh, parts, pairs, "psum", like)
    out = {}
    for h in heads:
        if mesh.rank_of(h) == mesh.rank:
            total = parts[h]
            for j in range(1, mesh.size("limb")):
                total = total + got[(j,) + h[1:], h]
            out[h] = total
    back = _transfer(mesh, out, [(h, m) for m, h in pairs], "psum", like)
    out.update({m: t for (_, m), t in back.items()})
    return out


def _ppermute_coeff_xor(mesh: HeMesh, parts: dict, d: int) -> dict:
    """Coeff block swap: shard s receives the block of shard s ^ d."""
    pairs = [((p[0], p[1] ^ d, p[2]), p) for p in mesh.positions]
    got = _transfer(mesh, parts, pairs, "ppermute", _first_block(parts))
    return {dst: t for (_, dst), t in got.items()}


def _block(mesh: HeMesh, x: torch.Tensor, spec, pos) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.size(axis) > 1:
            if x.shape[dim] % mesh.size(axis):
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not divide by "
                                 f"the mesh's {axis} axis ({mesh.size(axis)})")
            width = x.shape[dim] // mesh.size(axis)
            x = x.narrow(dim, pos[_AXES.index(axis)] * width, width)
    return x


def _scatter(mesh: HeMesh, x: torch.Tensor, spec) -> dict:
    """Global tensor -> one block per position of this process: dimension i
    is cut along the mesh axis spec[i] names (None: whole); positions along
    an axis that spec does not name hold copies (views, on the tensor's own
    device).  Every process holds the whole of x: nothing crosses them."""
    return {pos: _move(mesh, _block(mesh, x, spec, pos), pos, "scatter")
            for pos in mesh.local_positions}


def _gather(mesh: HeMesh, parts: dict, spec) -> torch.Tensor:
    """The inverse of _scatter, onto this process's first device (every
    process gets the whole); along an axis that spec does not name, the
    copy at index 0 is taken."""
    named = [(dim, axis) for dim, axis in enumerate(spec) if axis is not None]
    unnamed = [_AXES.index(a) for a in _AXES if a not in spec]
    sources = [p for p in mesh.positions if not any(p[i] for i in unnamed)]
    got = _transfer(mesh, parts, [(p, h) for p in sources for h in mesh.rank_heads],
                    "gather", _first_block(parts))
    mine = mesh.local_positions[0]

    def rec(pos, todo):
        if not todo:
            return got[tuple(pos), mine]
        (dim, axis), rest = todo[0], todo[1:]
        blocks = []
        for i in range(mesh.size(axis)):
            pos[_AXES.index(axis)] = i
            blocks.append(rec(pos, rest))
        return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=dim)
    return rec([0, 0, 0], named)


def shard_ciphertext_batch(mesh: HeMesh, arr: torch.Tensor) -> dict:
    """Place a [B, n, K] batch with B sharded over 'batch', replicated on
    the other axes: {position: block on that position's device}."""
    return _scatter(mesh, arr, ("batch", None, None))


# ---------------------------------------------------------------------------
# coefficient-axis NTT sharding (the long-sequence analogue, SURVEY.md §5)
# ---------------------------------------------------------------------------

def make_coeff_ntt_plan(pctx: PolyContext, dim: int, S: int) -> dict:
    """Host precompute for the coefficient-sharded NTT over S shards.

    Shard s holds the contiguous coefficient block [s*L, (s+1)*L), L = n/S.
    Stages with butterfly length >= L pair whole shards (partner = s XOR
    length/L, since blocks are shard-aligned) and use ONE zeta per
    (prime, stage, shard); stages with length < L are local and run the
    unmodified ntt()/intt() kernels over per-shard repacked zeta tables
    laid out exactly like the global ones (zl[nb:2nb] = stage-nb zetas).
    Twiddle indexing follows the reference tables (ref: src/ntt.c:37-73,
    src/precomp.c:244-264).
    """
    n = pctx.n
    assert S & (S - 1) == 0 and S >= 1
    L = n // S
    assert L >= 2, "need at least one local butterfly stage per shard"
    z = np.asarray(pctx.zetas(dim))          # [dim, n]
    zi = np.asarray(pctx.zetas_inv(dim))
    logS = S.bit_length() - 1

    # local tables: zl[d, s, j], layout zl[..., nb:2nb] = shard-s stage zetas
    def local_tables(tab):
        out = np.zeros((dim, S, L), dtype=np.uint64)
        nb = 1
        while nb <= L // 2:
            for s in range(S):
                out[:, s, nb:2 * nb] = tab[:, S * nb + s * nb: S * nb + (s + 1) * nb]
            nb *= 2
        return out

    # cross-stage zetas: forward lengths n/2 ... L (descending),
    # inverse lengths L ... n/2 (ascending); block(s) = s*L // (2*length)
    def cross_tables(tab, lengths):
        out = np.zeros((dim, max(1, logS), S), dtype=np.uint64)
        for t, length in enumerate(lengths):
            nblocks = n // (2 * length)
            for s in range(S):
                out[:, t, s] = tab[:, nblocks + (s * L) // (2 * length)]
        return out

    f_lengths = [n >> (1 + t) for t in range(logS)]          # n/2 ... L
    i_lengths = f_lengths[::-1]                              # L ... n/2
    return dict(
        S=S, L=L, logS=logS,
        f_lengths=f_lengths, i_lengths=i_lengths,
        zl_f=local_tables(z), zl_i=local_tables(zi),
        zc_f=cross_tables(z, f_lengths), zc_i=cross_tables(zi, i_lengths),
    )


def _coeff_tables(mesh: HeMesh, pctx: PolyContext):
    """(coefficient plan over the whole chain, {(device, coeff shard):
    ShardTables}) of a ring on this mesh, made once: a basis of dim primes
    uses the first dim rows, a limb shard a slice of those."""
    if pctx not in mesh._ring_tables:
        cp = make_coeff_ntt_plan(pctx, pctx.dimub, mesh.size("coeff"))
        word = 32 if ntt_module(pctx) is ntt_cuda32 else 64
        tables = {}
        for pos in mesh.local_positions:
            key = (mesh.device(pos), pos[1])
            if key not in tables:
                tables[key] = ntt_cuda.ShardTables(
                    pctx, cp["zl_f"][:, pos[1]], cp["zl_i"][:, pos[1]], key[0], word)
        mesh._ring_tables[pctx] = (cp, tables)
    return mesh._ring_tables[pctx]


def _ntt_coeff_sharded(mesh: HeMesh, x: dict, C: dict, pre: str, plan: dict) -> dict:
    """Forward NTT of the local [..., dim, L] coefficient blocks.  Cross
    stages first (one block swap each, one zeta per (prime, stage, shard)),
    then the local stages: the NTT kernel at length L on the shard's plan."""
    for t, length in enumerate(plan["f_lengths"]):
        d = length // plan["L"]
        recv = _ppermute_coeff_xor(mesh, x, d)

        def stage(pos):
            c = C[pos]
            p, pv = c[pre + "_ps"][:, None], c[pre + "_pinv"][:, None]
            zt = c[pre + "_zcf"][:, t, pos[1]][:, None]
            if pos[1] & d == 0:         # the lower half of the butterfly
                return addmod(x[pos], mont_mul(recv[pos], zt, p, pv), p)
            return submod(recv[pos], mont_mul(x[pos], zt, p, pv), p)
        x = {pos: stage(pos) for pos in x}
    return _each(lambda a, c: plan["ntt"].ntt(a, c[pre + "_ntt"]), x, C)


def _intt_coeff_sharded(mesh: HeMesh, x: dict, C: dict, pre: str, plan: dict) -> dict:
    """Inverse NTT of the local [..., dim, L] blocks: local GS stages (with
    the global n^-1 scale — a scalar multiply commutes with later
    butterflies), then cross stages ascending."""
    x = _each(lambda a, c: plan["ntt"].intt(a, c[pre + "_ntt"]), x, C)
    for t, length in enumerate(plan["i_lengths"]):
        d = length // plan["L"]
        recv = _ppermute_coeff_xor(mesh, x, d)

        def stage(pos):
            c = C[pos]
            p, pv = c[pre + "_ps"][:, None], c[pre + "_pinv"][:, None]
            if pos[1] & d == 0:
                return addmod(x[pos], recv[pos], p)
            zt = c[pre + "_zci"][:, t, pos[1]][:, None]
            return mont_mul(submod(recv[pos], x[pos], p), zt, p, pv)
        x = {pos: stage(pos) for pos in x}
    return x


# ---------------------------------------------------------------------------
# per-shard constants
# ---------------------------------------------------------------------------

def _pad_dim(dim: int, nlimb: int, dimub: int) -> int:
    """Round a basis size up to a multiple of the limb-axis size (extra chain
    primes only enlarge the CRT range — exactness is preserved)."""
    p = ((dim + nlimb - 1) // nlimb) * nlimb
    assert p <= dimub, (dim, nlimb, dimub)
    return p


def _per_limb_shard(mesh: HeMesh, dim: int, make) -> dict:
    """{position: make(device, r0, r1)} with rows r0..r1-1 of a dim-prime
    stack on limb shard j; positions that share a device and a limb index
    share the result."""
    rows = dim // mesh.size("limb")
    made = {}
    out = {}
    for pos in mesh.local_positions:
        key = (mesh.device(pos), pos[0])
        if key not in made:
            made[key] = make(key[0], pos[0] * rows, (pos[0] + 1) * rows)
        out[pos] = made[key]
    return out


def _basis_consts(mesh: HeMesh, pctx: PolyContext, dim: int, k_in: int, prefix: str):
    """(static plan, per-shard constants) of a limb+coeff-sharded NTT basis
    of dim primes: the shard's primes with their Montgomery constants and
    decompose weights, its cross-stage zetas [rows, stage, S] and the plan
    of its local stages."""
    assert dim % mesh.size("limb") == 0, (dim, mesh.size("limb"))
    b = pctx.basis(dim)
    cp, tables = _coeff_tables(mesh, pctx)
    splan = dict(S=cp["S"], L=cp["L"], logS=cp["logS"], f_lengths=cp["f_lengths"],
                 i_lengths=cp["i_lengths"], ntt=ntt_module(pctx))
    w = rns_ops.make_decomp_weights(pctx, dim, k_in)
    host = dict(ps=b.ps, pinv=b.pinv_mont, r2=b.r2, w=w,
                zcf=cp["zc_f"][:dim], zci=cp["zc_i"][:dim])

    def shard(dev, r0, r1):
        return {f"{prefix}_{k}": u64_to_torch(v[r0:r1], dev) for k, v in host.items()}
    consts = _per_limb_shard(mesh, dim, shard)
    rows = dim // mesh.size("limb")
    return splan, {pos: {**consts[pos], f"{prefix}_ntt": tables[mesh.device(pos), pos[1]].plan(
        pos[0] * rows, (pos[0] + 1) * rows)} for pos in mesh.local_positions}


def _recon_consts(mesh: HeMesh, pctx: PolyContext, dim_basis: int, dim_padded: int,
                  prefix: str) -> dict:
    """Per-shard constants of a limb-sharded reconstruct over the first
    dim_basis primes of a dim_padded-prime residue stack.  When dim_basis <
    dim_padded (sub-basis reconstruction, e.g. r = c mod P in the key-switch
    divide-round), the out-of-basis primes get phatinv = 0 and zero plan
    rows, so their digit and alpha contributions vanish under the limb sum."""
    phinv = np.zeros(dim_padded, dtype=np.uint64)
    phinv[:dim_basis] = pctx.basis(dim_basis).phatinv_mont

    def shard(dev, r0, r1):
        return {f"{prefix}_phinv": u64_to_torch(phinv[r0:r1], dev),
                f"{prefix}_plan": rns_ops.make_recon_plan(pctx, dim_basis, dev, rows=(r0, r1))}
    return _per_limb_shard(mesh, dim_padded, shard)


def _reconstruct(mesh: HeMesh, res: dict, C: dict, pre: str, rpre: str, center: bool) -> dict:
    """Limb-sharded CRT lift of the local residues over basis `pre` with
    the reconstruct constants `rpre`; every shard gets the limbs."""
    consts = {pos: (c[pre + "_ps"], c[pre + "_pinv"], c[rpre + "_phinv"], c[rpre + "_plan"])
              for pos, c in C.items()}
    return rns_ops.reconstruct_sharded(res, consts, lambda parts: _psum_limb(mesh, parts),
                                       center=center)


def _ks_post_factory(eng, l: int, mesh: HeMesh, C: dict):
    """Shared sharded divide-round-by-P pipeline: inverse-NTT'd product
    stack res (key-switch halves, local primes of basis "s") -> u =
    rdiv(c, P) mod q_l limbs.  Mirrors CKKS._keyswitch_core's post()
    (ref: src/he-mult.c:67-77, he-automorphism.c:62-77): full-basis centered
    reconstruct ("sr") + sub-basis r = c mod P ("r8": zero-masked
    out-of-basis primes under the limb sum), then (c - r) * P^-1 mod
    2^(32 kq) + round bit."""
    qb, klv, kq = eng.qbits(l), eng.kl(l), eng.kq
    pinv16, rk8 = eng.pinv16, eng.rk8
    p_half_up = {pos: eng.p_half_up.to(mesh.device(pos)) for pos in mesh.local_positions}

    def finish(c, r, half):
        u = lb.mul_const_mod2k(lb.sub(lb.resize(c, kq), lb.resize(r, kq)), pinv16, kq)
        u = lb.add_scalar_bit(u, lb.geq_const(lb.resize(r, rk8), half))
        return lb.resize(lb.mask_bits(u, qb), klv)

    def ks_post(res):
        c = _reconstruct(mesh, res, C, "s", "sr", center=True)
        r = _reconstruct(mesh, res, C, "s", "r8", center=False)
        return _each(finish, c, r, p_half_up)
    return ks_post


def _consts_c(c: dict, pre: str) -> tuple:
    """(p, pinv, r2) [rows, 1] of the shard's primes of basis `pre`."""
    return c[pre + "_ps"][:, None], c[pre + "_pinv"][:, None], c[pre + "_r2"][:, None]


def _decompose_c(x, c: dict, pre: str):
    return rns_ops.decompose_core(x, c[pre + "_ps"], c[pre + "_pinv"], c[pre + "_w"])


# ---------------------------------------------------------------------------
# the sharded programs
# ---------------------------------------------------------------------------

_CT = ("batch", "coeff", None)       # ciphertext limbs [B, n, K]
_KEY = ("limb", "coeff")             # NTT-resident key halves [dim, n]


def _program(mesh: HeMesh, owner: graphs.Graphs, fn, key, bound=()):
    """fn as one program of the mesh: on a graphable mesh a graphs.Program
    of owner's (a CUDA graph per argument shapes and device; bound: the
    arguments its graphs read in place), elsewhere fn itself."""
    return owner.program(fn, key, bound) if mesh.graphable else fn


def _batch(mesh: HeMesh, x: torch.Tensor) -> torch.Tensor:
    """A ciphertext poly [n, K] seen as the batch [B, n, K] of the mesh's
    batch axis (a view: inside a program, so that a graph's static input
    is the one poly); a batch [B, n, K] as it is."""
    return x if x.dim() == 3 else x[None].expand((mesh.size("batch"),) + tuple(x.shape))


def _build_poly_mul(pctx: PolyContext, dim: int, k_in: int, mask_to_bits: int,
                    k_out: int, mesh: HeMesh):
    assert dim % mesh.size("limb") == 0, (dim, mesh.size("limb"))
    splan, ca = _basis_consts(mesh, pctx, dim, k_in, "a")
    C = _merge(ca, _recon_consts(mesh, pctx, dim, dim, "ar"))

    def run(a, bb):
        def fwd(x):
            res = _each(lambda v, c: _decompose_c(v, c, "a"), _scatter(mesh, x, _CT), C)
            return _ntt_coeff_sharded(mesh, res, C, "a", splan)
        ch = _each(lambda x, y, c: mulmod(x, y, *_consts_c(c, "a")), fwd(a), fwd(bb), C)
        res = _intt_coeff_sharded(mesh, ch, C, "a", splan)
        c = _reconstruct(mesh, res, C, "a", "ar", center=True)
        return _gather(mesh, _each(lambda v: lb.fit_signed(v, mask_to_bits, k_out), c), _CT)
    return _program(mesh, mesh.graphs, run, ("sharded_poly_mul", dim, k_in, mask_to_bits, k_out))


def build_sharded_poly_mul(pctx: PolyContext, dim: int, k_in: int,
                           mask_to_bits: int, k_out: int, mesh: HeMesh):
    """Batched negacyclic product sharded over a (limb, batch) mesh.

    Returns the program fn(a, b) for limb inputs [B, n, k_in] (B sharded
    over 'batch'); the dim primes are sharded over 'limb'.  dim must divide
    by the limb axis size.  Its graphs are the mesh's (HeMesh.graphs)."""
    assert mesh.size("coeff") == 1, "use build_sharded_poly_mul_3d on a coeff axis"
    return _build_poly_mul(pctx, dim, k_in, mask_to_bits, k_out, mesh)


def build_sharded_poly_mul_3d(pctx: PolyContext, dim: int, k_in: int,
                              mask_to_bits: int, k_out: int, mesh: HeMesh):
    """Negacyclic product sharded over the full (limb, coeff, batch) mesh.

    The program fn(a, b) for limb inputs [B, n, k_in]; B shards over
    'batch', the n coefficients over 'coeff', the dim primes over 'limb'.
    Per NTT the 'coeff' axis exchanges log2(S) blocks; the CRT lift sums
    digit partials over 'limb'; everything else is local."""
    return _build_poly_mul(pctx, dim, k_in, mask_to_bits, k_out, mesh)


def build_sharded_rot(eng, l: int, mesh: HeMesh, rot: int | None):
    """Slot rotation / conjugation (rot=None) sharded over the full
    (limb, coeff, batch) mesh — the key-switch path of
    CKKS.rot/conj/_apply_swk (ref: src/he-automorphism.c:40-115).

    The Galois permutation is a global coefficient gather (it crosses coeff
    shards), so it runs on the global view before the scatter (the ring's
    galois programs, inline in this one); the key-switch pipeline itself —
    decompose + coeff-sharded NTT of d1, x swk halves (swk sharded over
    (limb, coeff)), INTT of both halves in one launch a shard, the two
    limb-sum reconstructs and the divide-round — runs shard by shard
    exactly like the relin block of build_sharded_mul_rs.

    Returns the program fn(c0, c1, swk0, swk1) -> (c0', c1') for limb
    inputs [B, n, klv] (B over 'batch', n over 'coeff'), or [n, klv] for one
    ciphertext (then the results are [n, klv]); swk halves are the engine's
    NTT-resident [>=dim_s, n], read in place by its graphs.  Bit-exact vs
    the single-device engine op."""
    ctx = eng.ctx
    pctx = ctx.poly
    qb, klv = eng.qbits(l), eng.kl(l)
    dim_s = _pad_dim(ctx.dim_swk(l), mesh.size("limb"), pctx.dimub)
    assert dim_s <= eng.dimswk_h, (dim_s, eng.dimswk_h)

    splan_s, cs = _basis_consts(mesh, pctx, dim_s, klv, "s")
    C = _merge(cs, _recon_consts(mesh, pctx, dim_s, dim_s, "sr"),
               _recon_consts(mesh, pctx, ctx.dim, dim_s, "r8"))
    ks_post = _ks_post_factory(eng, l, mesh, C)

    def run(c0, c1, ek0, ek1):
        d0, d1 = (_scatter(mesh, _batch(mesh, eng.ring.galois(x, rot, qb)), _CT)
                  for x in (c0, c1))
        ek0, ek1 = _scatter(mesh, ek0[:dim_s], _KEY), _scatter(mesh, ek1[:dim_s], _KEY)
        dhat = _ntt_coeff_sharded(mesh, _each(lambda v, c: _decompose_c(v, c, "s"), d1, C),
                                  C, "s", splan_s)
        uh = _each(lambda d, e0, e1, c: key_products(d, e0, e1, *_consts_c(c, "s")),
                   dhat, ek0, ek1, C)
        u = ks_post(_intt_coeff_sharded(mesh, uh, C, "s", splan_s))
        c0 = _each(lambda v, d: lb.mask_bits(lb.add(v[0], d), qb), u, d0)
        out = _gather(mesh, c0, _CT), _gather(mesh, _each(lambda v: v[1], u), _CT)
        return out if c1.dim() == 3 else (out[0][0], out[1][0])
    return _program(mesh, eng.ring.graphs, run, ("sharded_rot", l, rot), bound=(2, 3))


def build_sharded_gemv_step(eng, l: int, n1: int | None, dims_h: int, dimc: int,
                            mesh: HeMesh):
    """One double-hoisted BSGS gemv giant step sharded over (limb, coeff)
    — the body of CKKS.hoisted_gemv_step_fn (pointwise per prime, so it
    runs unchanged on local shards: one batched product over the baby-step
    axis and a pairwise sum mod p; only the key-switch divide-round needs
    the limb sum) plus the sharded key-switch epilogue.  The rotation-key
    slab rk0/rk1 [n1, dims_h, n] — the largest object in the system at
    production scale (ref: src/he-kem.c:154-169) — shards over
    (limb, coeff) like the evk.  n1 is read from the arguments.

    dims_h and dimc must be multiples of the limb axis (pad with extra
    chain primes — any dims >= the engine's formulas are valid CRT ranges).

    The program f(c1p [n1,dims_h,n], c0p [n1,dimc,n], ptx_i, ptb_i, rk0,
    rk1) -> (c0_i, c1_i) [n, klv], bit-exact vs the engine step; its graphs
    read the diagonal slabs and the key stacks in place, as the engine's."""
    ctx = eng.ctx
    pctx = ctx.poly
    nlimb = mesh.size("limb")
    qb, klv = eng.qbits(l), eng.kl(l)
    assert dims_h % nlimb == 0 and dimc % nlimb == 0, (dims_h, dimc, nlimb)
    assert dims_h <= eng.dimswk_h, (dims_h, eng.dimswk_h)

    splan_s, cs = _basis_consts(mesh, pctx, dims_h, klv, "s")
    splan_c, cc = _basis_consts(mesh, pctx, dimc, klv, "c")
    C = _merge(cs, cc, _recon_consts(mesh, pctx, dims_h, dims_h, "sr"),
               _recon_consts(mesh, pctx, ctx.dim, dims_h, "r8"),
               _recon_consts(mesh, pctx, dimc, dimc, "cr"))
    ks_post = _ks_post_factory(eng, l, mesh, C)
    slab = (None, "limb", "coeff")

    def run(c1p, c0p, ptx, ptb, rk0, rk1):
        args = [_scatter(mesh, x, slab)
                for x in (c1p, c0p, ptx, ptb, rk0[:, :dims_h], rk1[:, :dims_h])]

        def sums(c1j, c0j, px, pb, rr0, rr1, c):
            return (mulmod_sum(c1j, px, *_consts_c(c, "s"), ws=(rr0, rr1)),
                    mulmod_sum(c0j, pb, *_consts_c(c, "c"))[0])
        acc = _each(sums, *args, C)
        k = ks_post(_intt_coeff_sharded(mesh, _each(lambda a: a[0], acc), C, "s", splan_s))
        resb = _intt_coeff_sharded(mesh, _each(lambda a: a[1], acc), C, "c", splan_c)
        db = _reconstruct(mesh, resb, C, "c", "cr", center=True)
        c0 = _each(lambda v, d: lb.mask_bits(
            lb.add(v[0], lb.resize(lb.mask_bits(d, qb), klv)), qb), k, db)
        out = ("coeff", None)
        return _gather(mesh, c0, out), _gather(mesh, _each(lambda v: v[1], k), out)
    return _program(mesh, eng.ring.graphs, run, ("sharded_gemv_step", l, dims_h, dimc),
                    bound=(2, 3, 4, 5))


def build_sharded_mul_rs(eng, l: int, mesh: HeMesh):
    """The north-star scheme op — fused ciphertext multiply + relinearize +
    rescale (engine mul_rs) — sharded over the full (limb, coeff, batch) mesh.

    Mirrors CKKS.mul_step_fn exactly (ref: src/he-mult.c:88-156 pipeline):
      - cross terms d0/d1/d2 over the dim_mul basis: decompose + NTT local
        per limb shard (the reference's d-loop, ref: src/he-mult.c:116-138),
        coeff-axis block swaps inside each NTT, one limb-axis sum per CRT
        reconstruct; a shard's four forward and three inverse transforms
        ride one kernel launch each, as on the single device;
      - relinearization over the dim_swk basis with the evk sharded
        (limb = prime axis, coeff = NTT position axis);
      - divide-round by P via the small-CRT remainder (a SECOND, sub-basis
        sum with zero-masked out-of-basis primes), then the rescale
        shift+round — all coefficient-local.

    Returns the program fn(c10, c11, c20, c21, ek0, ek1) -> (c0, c1) for
    limb inputs [B, n, klv] (B over 'batch', n over 'coeff'), or [n, klv]
    for one ciphertext pair (then the results are [n, klv]); ek0/ek1 are
    the evk's NTT-resident halves, read in place by its graphs.  Bit-exact
    vs the single-device engine program."""
    ctx = eng.ctx
    pctx = ctx.poly
    nlimb = mesh.size("limb")
    qb, klv = eng.qbits(l), eng.kl(l)
    dim_m = _pad_dim(ctx.dim_mul(l), nlimb, pctx.dimub)
    dim_s = _pad_dim(ctx.dim_swk(l), nlimb, pctx.dimub)
    assert dim_s <= eng.dimswk_h, \
        (f"padded relin basis {dim_s} exceeds switch-key limbs "
         f"{eng.dimswk_h}; raise hoist_bits at engine construction")

    splan_m, cm = _basis_consts(mesh, pctx, dim_m, klv, "m")
    splan_s, cs = _basis_consts(mesh, pctx, dim_s, klv, "s")
    C = _merge(cm, cs, _recon_consts(mesh, pctx, dim_m, dim_m, "mr"),
               _recon_consts(mesh, pctx, dim_s, dim_s, "sr"),
               _recon_consts(mesh, pctx, ctx.dim, dim_s, "r8"))
    ks_post = _ks_post_factory(eng, l, mesh, C)

    def run(c10, c11, c20, c21, ek0, ek1):
        cts = [_scatter(mesh, _batch(mesh, x), _CT) for x in (c10, c11, c20, c21)]
        ek0, ek1 = _scatter(mesh, ek0[:dim_s], _KEY), _scatter(mesh, ek1[:dim_s], _KEY)
        dec = _each(lambda *a: torch.stack([_decompose_c(v, a[-1], "m") for v in a[:-1]]),
                    *cts, C)
        dh = _each(lambda x, c: cross_terms(x, *_consts_c(c, "m")),
                   _ntt_coeff_sharded(mesh, dec, C, "m", splan_m), C)
        res = _intt_coeff_sharded(mesh, dh, C, "m", splan_m)
        d = _each(lambda v: lb.resize(lb.mask_bits(v, qb), klv),
                  _reconstruct(mesh, res, C, "m", "mr", center=True))       # d0, d1, d2
        # relinearize d2 over the padded dim_swk basis
        d2hat = _ntt_coeff_sharded(mesh, _each(lambda v, c: _decompose_c(v[2], c, "s"), d, C),
                                   C, "s", splan_s)
        uh = _each(lambda x, e0, e1, c: key_products(x, e0, e1, *_consts_c(c, "s")),
                   d2hat, ek0, ek1, C)
        u = ks_post(_intt_coeff_sharded(mesh, uh, C, "s", splan_s))
        out = _each(lambda v, w: eng._rs_limbs(lb.mask_bits(lb.add(v, w[:2]), qb), l - 1), u, d)
        both = _gather(mesh, out, (None,) + _CT)
        return (both[0], both[1]) if c10.dim() == 3 else (both[0, 0], both[1, 0])
    return _program(mesh, eng.ring.graphs, run, ("sharded_mul_rs", l), bound=(4, 5))
