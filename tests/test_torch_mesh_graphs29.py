"""The tests of test_torch_mesh_graphs.py that depend on the chain, on the
logp=29 chain (the 30-bit primes that the u32 NTT kernel serves on the
card): each sharded program graphed through the stand-in against the JAX
package's program and the eager port, its counters and bound constants,
and MeshCKKS against the single-device engine.  A file of its own so that
the JAX programs of the two chains build in parallel workers.
"""

import torch

from test_torch_mesh_graphs import (engines, runs,  # noqa: F401  (fixtures)
                                    test_constants_are_read_in_place,
                                    test_graphed_program_bit_equal_to_jax_and_eager,
                                    test_mesh_engine_ops_graphed_equal_single_device,
                                    test_one_graph_a_shape,
                                    test_replays_count_the_traffic_and_launches_of_eager_calls)

torch.set_num_threads(1)

LOGP = 29
