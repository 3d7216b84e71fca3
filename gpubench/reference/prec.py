"""Complex arithmetic in a chosen real precision, for the plaintext circuits.

A complex tensor is held as its real and imaginary parts in one torch dtype
(float64 for the reference, float32 or bfloat16 for the lower-precision
control), so every operation rounds as that precision would.  Plain PyTorch
on any device; matrix products are written as products and sums, so no
TF32 path is taken on a GPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}


def unit_box(rng: np.random.Generator, shape, scale: float = 1.0) -> np.ndarray:
    """Complex values with real and imaginary parts uniform in [-scale, scale)."""
    return scale * (rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape))


@dataclass
class Cx:
    re: torch.Tensor
    im: torch.Tensor

    @classmethod
    def of(cls, z, dtype: str, device: str = "cpu") -> "Cx":
        z = np.asarray(z, dtype=np.complex128)
        dt = DTYPES[dtype]
        return cls(torch.tensor(z.real, dtype=torch.float64).to(device=device, dtype=dt),
                   torch.tensor(z.imag, dtype=torch.float64).to(device=device, dtype=dt))

    def numpy(self) -> np.ndarray:
        re = self.re.to(torch.float64).cpu().numpy()
        im = self.im.to(torch.float64).cpu().numpy()
        return re + 1j * im

    def mul(self, o: "Cx") -> "Cx":
        return Cx(self.re * o.re - self.im * o.im, self.re * o.im + self.im * o.re)

    def add(self, o: "Cx") -> "Cx":
        return Cx(self.re + o.re, self.im + o.im)

    def sub(self, o: "Cx") -> "Cx":
        return Cx(self.re - o.re, self.im - o.im)

    def neg(self) -> "Cx":
        return Cx(-self.re, -self.im)

    def scale(self, c: float) -> "Cx":
        return Cx(self.re * c, self.im * c)

    def add_real(self, c: float) -> "Cx":
        return Cx(self.re + c, self.im)

    def matvec(self, a: "Cx") -> "Cx":
        """a @ self over the last axis: a [..., m, m], self [..., m]."""
        return Cx((a.re * self.re[..., None, :] - a.im * self.im[..., None, :]).sum(-1),
                  (a.re * self.im[..., None, :] + a.im * self.re[..., None, :]).sum(-1))
