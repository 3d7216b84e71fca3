"""Homomorphic algorithm layer (ref: src/he-algo.c)."""

from .linalg import (  # noqa: F401
    GemvPlan, HoistedGemvPlan, gemv, gemv_hoisted, gemv_hoisted_full, he_idx,
    he_nrm2, he_sum, zrotdiag)
from .nonlinear import (  # noqa: F401
    he_cmp, he_cmppt, he_exp, he_inv, he_log, he_sigmoid, he_sqrt)
