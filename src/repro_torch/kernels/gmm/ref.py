"""Plain-PyTorch oracle for the grouped matmul (the reference's
``gmm_ref``), in the operands' type."""
import torch


def gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ecd,edf->ecf", x, w)
