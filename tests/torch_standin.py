"""StandIn, the capture primitive's stand-in on the CPU, shared by the
tests of utils/graphs.py (tests/test_torch_graphs.py) and of the mesh's
graphed programs (tests/test_torch_mesh_graphs*.py).  A test hands it to a
Graphs (`eng.ring.graphs = graphs.Graphs(StandIn())`); nothing in the
package chooses it.
"""

from gpqhe_tpu_torch.utils import graphs


class StandIn:
    """The capture primitive's stand-in on the CPU: a replay runs the
    program again, its inner programs inline as in the capture.  fail: a
    capture raises, as a capture of an operation the stream cannot capture
    does; fail_replay: a replay raises."""

    def __init__(self, fail: bool = False, fail_replay: bool = False):
        self.fail, self.fail_replay = fail, fail_replay
        self.warm_ups = 0

    def takes(self, device):
        return device.type == "cpu"

    def new_pool(self, device):
        return object()

    def warm_up(self, fn, args, device):
        self.warm_ups += 1
        return fn(*args)

    def capture(self, fn, args, pool, device):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        out = fn(*args)

        def replay():
            if self.fail_replay:
                raise RuntimeError("CUDA error: the graph failed to launch")
            snap = graphs.counters_snapshot()
            with graphs.inline():
                new = fn(*args)
            graphs.counters_restore(snap)
            for o, n in zip(graphs._tensors(out), graphs._tensors(new)):
                o.copy_(n)
        return replay, out
