"""gpqhe_tpu_torch — the CKKS framework on PyTorch, with CUDA kernels for Hopper.

A port of the JAX package gpqhe_tpu, module for module: the host-only
modules (params, context, substrate, ring/sample, ring/canemb) are copies,
the device code is torch, and the TPU's Pallas NTT kernel is a hand-written
CUDA kernel (csrc/ntt.cu, bound in ops/ntt_cuda.py).  It imports torch and
numpy, never jax.  Engines take a device:

    ckks = CKKS(HeContext(14, 1 << 438, 16, 1 << 50), rng=Surf(),
                device=torch.device("cuda"))
"""

from .context import HeContext, PolyContext  # noqa: F401
from .scheme.engine import CKKS  # noqa: F401
from .scheme.types import (  # noqa: F401
    Ciphertext, Plaintext, PublicKey, SecretKey, SwitchKey)
from .substrate.surf import Surf  # noqa: F401
