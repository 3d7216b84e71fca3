"""What the request kinds share on the program's side: an engine of
gpqhe_tpu_torch for a configuration, the secret key the benchmark made
handed to it, and fresh ciphertexts encrypted under it.

The engine's own random stream (the noise of encryption and of the keys) is
seeded from the run's seed, so one seed gives the same inputs every time.
"""

from __future__ import annotations

import numpy as np

from gpqhe_tpu_torch.context import HeContext
from gpqhe_tpu_torch.scheme.engine import CKKS
from gpqhe_tpu_torch.scheme.types import SecretKey, limbs_to_torch
from gpqhe_tpu_torch.substrate import bigint
from gpqhe_tpu_torch.substrate.surf import Surf


def engine(cfg: dict, seed: int, device) -> CKKS:
    ctx = HeContext(logn=cfg["logn"], q=1 << cfg["logq"], slots=cfg["slots"],
                    Delta=1 << cfg["logDelta"], logp=cfg["logp"])
    words = np.random.SeedSequence([seed, 7]).generate_state(32, dtype=np.uint32)
    return CKKS(ctx, rng=Surf(seed=words), device=device, ntt_impl=cfg["ntt_impl"])


def secret_key(eng: CKKS, s: np.ndarray) -> SecretKey:
    """The benchmark's ternary secret as the engine's key object."""
    return SecretKey(s=limbs_to_torch(bigint.i64_to_limbs(np.asarray(s, dtype=np.int64), 1),
                                      eng.device))


def encrypt(eng: CKKS, sk: SecretKey, m) -> object:
    """A fresh ciphertext of the slots m at the top level."""
    return eng.enc_sk(eng.ecd(np.asarray(m, dtype=np.complex128)), sk)
