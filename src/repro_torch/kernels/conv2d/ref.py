"""Plain-PyTorch oracle for conv2d ('same' correlation).

On a GPU the caller pins ``torch.backends.cudnn.allow_tf32 = False``:
cuDNN's default TF32 keeps about three decimal digits."""
import torch
import torch.nn.functional as F


def conv2d_ref(img: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    K = w.shape[0]
    out = F.conv2d(img[None, None].float(), w[None, None].float(),
                   padding=K // 2)
    return out[0, 0].to(img.dtype)
