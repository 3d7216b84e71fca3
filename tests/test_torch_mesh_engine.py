"""The sharded programs of the port's parallel/mesh.py on the default 59-bit
chain: build_sharded_mul_rs, build_sharded_rot (rotation and conjugation)
and build_sharded_gemv_step on a virtual (2, 2, 2) CPU mesh, np.array_equal
to the JAX package's programs and to the port's single-device engine.  The
cases are in torch_mesh_cases.py; test_torch_mesh_engine29.py runs them on
the logp=29 chain.
"""

import pytest
import torch

from torch_mesh_cases import MeshCase

torch.set_num_threads(1)

LOGP = 59


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
