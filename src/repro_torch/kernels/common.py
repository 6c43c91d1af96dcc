"""Plain PyTorch counterparts of ``repro.kernels.common``: sign-bit
unpack, N:M expand, the binary ⊙ rank-r term and the no-binary low-rank
projection, with the rounding of the kernels they stand beside (the CUDA
versions are in ``csrc/slab_common.cuh``)."""
from __future__ import annotations

import torch


def unpack_bits(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, W) sign words (uint32 bits in int32) -> (N, 32W) ±1 in
    ``dtype``. The int32 shift is arithmetic, so the mask follows it."""
    n, words = packed.shape
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    pos = ((packed[:, :, None] >> shifts) & 1) != 0
    one = torch.ones((), dtype=dtype, device=packed.device)
    return torch.where(pos, one, -one).reshape(n, words * 32)


def expand_nm(vals: torch.Tensor, idx: torch.Tensor, m: int,
              dtype=torch.float32) -> torch.Tensor:
    """(N, G, n) values + int8 positions -> dense (N, G*m)."""
    n_rows, g, _ = vals.shape
    dense = torch.zeros((n_rows, g, m), dtype=dtype, device=vals.device)
    dense.scatter_add_(2, idx.long(), vals.to(dtype))
    return dense.reshape(n_rows, g * m)


def binlr_term(x: torch.Tensor, b_packed: torch.Tensor, u: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """Σ_r ((x ⊙ v_r) @ Bᵀ) ⊙ u_r in fp32 for x (M, K), u (R, N),
    v (R, K). ``x ⊙ v_r`` is formed in x.dtype, as the kernels do."""
    b = unpack_bits(b_packed, torch.float32)
    y = torch.zeros((x.shape[0], b.shape[0]), dtype=torch.float32,
                    device=x.device)
    for r in range(u.shape[0]):
        xv = (x * v[r].to(x.dtype)).float()
        y = y + (xv @ b.T) * u[r].float()
    return y


def lowrank_term(x: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """(x @ Vᵀ) @ U for x (M, K), u (R, N), v (R, K): the projection
    p = x @ Vᵀ (M, R) is formed from fp32 copies of x and v (no rounding
    through x.dtype, unlike the binary term), then applied through U."""
    p = x.float() @ v.float().T
    return p @ u.float()
