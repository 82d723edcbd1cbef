"""Plain-PyTorch oracle for the histogram kernel: a scatter-add of ones
(what ``jnp.bincount`` lowers to).  Keys outside [0, n_bins) count
nowhere, as in the kernels."""
import torch


def hist_ref(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    x = x.reshape(-1).long()
    x = x[(x >= 0) & (x < n_bins)]
    out = torch.zeros(n_bins, dtype=torch.int64, device=x.device)
    out.scatter_add_(0, x, torch.ones_like(x))
    return out.to(torch.int32)
