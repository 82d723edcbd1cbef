"""Plain-PyTorch oracle for the row sorter."""
import torch


def sort_rows_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=1).values
