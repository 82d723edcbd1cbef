"""Plain-PyTorch oracles for spmv (ELL and dense forms)."""
import torch


def spmv_ell_ref(vals: torch.Tensor, idx: torch.Tensor, x: torch.Tensor
                 ) -> torch.Tensor:
    """vals/idx: (R, K) ELL with zero-padded vals. Returns (R,)."""
    return (vals * x[idx.long()]).sum(dim=1)


def spmv_dense_ref(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return A @ x
