"""The sharded programs of the port's parallel/mesh.py on the logp=29 chain
(the 30-bit primes that the u32 NTT kernel serves on the card): the cases of
test_torch_mesh_engine.py, from torch_mesh_cases.py.  A file of its own so
that the JAX programs of the two chains build in parallel workers.
"""

import pytest
import torch

from torch_mesh_cases import MeshCase

torch.set_num_threads(1)

LOGP = 29


@pytest.fixture(scope="module")
def case():
    return MeshCase(LOGP)


def test_sharded_mul_rs_matches_jax_and_engine(case):
    case.mul_rs()
    t = case.mesh.traffic
    assert t["psum"][0] > 0 and t["ppermute"][0] > 0 and t["gather"][0] > 0


@pytest.mark.parametrize("r", [1, None], ids=["rot1", "conj"])
def test_sharded_rot_conj_matches_jax_and_engine(case, r):
    case.rot(r)


def test_sharded_gemv_step_matches_jax_and_engine(case):
    case.gemv_step()
