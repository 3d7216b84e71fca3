"""The transport under a mesh that spans processes (parallel/mesh.py).

What jax.distributed and GSPMD give the JAX package, written out for
torch.distributed: every process (rank) holds some positions of one global
(limb, coeff, batch) mesh, and data crosses ranks only inside the mesh's
three collectives, as point-to-point messages.

A collective step is a list of moves (source position, destination
position) that every rank builds from the global position list, so all
ranks see the same list in the same order.  schedule() reads this rank's
part of it: a move between two of its own positions is local (a .to()),
a move out of it a send, a move into it a receive.  Between any two ranks
the sends of one and the receives of the other come in the same order, and
exchange() posts all of a step's messages at once before it waits on any,
so no rank waits on a receive that its peer has not yet reached.

A gloo group moves CPU tensors only: a CUDA block is staged through host
memory (parallel/mesh.py, chosen by the group's backend, counted in the
mesh's traffic).  An nccl group moves the CUDA tensors themselves.
"""

from __future__ import annotations

import datetime

import torch.distributed as dist


def init_group(rank: int, world: int, store: str, backend: str, timeout_s: float):
    """Join a group of `world` processes that meet in the file `store` (a
    torch FileStore: no fixed port to agree on); every wait on it or on a
    message ends after timeout_s with an error."""
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def gather_device_lists(group, devices) -> list[list[str]]:
    """Every rank's list of local devices, in rank order (the role
    jax.devices() plays under jax.distributed)."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, [str(d) for d in devices], group=group)
    return out


def stages_through_host(group) -> bool:
    """Whether a CUDA tensor must cross this group through host memory."""
    backend = dist.get_backend(group)
    if backend == "gloo":
        return True
    if backend == "nccl":
        return False
    raise ValueError(f"no point-to-point transport for the {backend!r} backend")


def schedule(rank_of_pos, moves, rank: int) -> list[tuple[str, int, tuple]]:
    """This rank's part of one collective step: ("local", rank, move),
    ("send", peer, move) or ("recv", peer, move), in the order of moves.
    rank_of_pos maps a mesh position to the rank that holds it."""
    out = []
    for move in moves:
        a, b = rank_of_pos(move[0]), rank_of_pos(move[1])
        if a == b == rank:
            out.append(("local", rank, move))
        elif a == rank:
            out.append(("send", b, move))
        elif b == rank:
            out.append(("recv", a, move))
    return out


def exchange(group, ops) -> None:
    """Post every message of a step, then wait for all of them: ops is
    [("send" | "recv", peer rank, contiguous tensor)].  A failed message,
    or a peer that does not answer within the group's timeout, raises."""
    if not ops:
        return
    p2p = []
    for op, peer, t in ops:
        if not t.is_contiguous():
            raise ValueError("a message must be a contiguous tensor")
        p2p.append(dist.P2POp(dist.isend if op == "send" else dist.irecv, t, peer, group=group))
    for req in dist.batch_isend_irecv(p2p):
        req.wait()
