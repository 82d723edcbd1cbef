"""Plain-PyTorch oracle for the bilateral filter (direct, no LUT)."""
import math

import torch
import torch.nn.functional as F


def bilateral_ref(img: torch.Tensor, sigma_s: float, sigma_r: float,
                  radius: int) -> torch.Tensor:
    """Direct evaluation with edge padding; quantized range difference to
    match the kernel's integer LUT indexing."""
    H, W = img.shape
    K = 2 * radius + 1
    padded = F.pad(img[None, None], (radius,) * 4, mode="replicate")[0, 0]
    num = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    den = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    for di in range(K):
        for dj in range(K):
            nb = padded[di:di + H, dj:dj + W]
            d2 = (di - radius) ** 2 + (dj - radius) ** 2
            sw = math.exp(-d2 / (2 * sigma_s ** 2))
            diff = (nb - img).abs().to(torch.int32).clamp(0, 255)
            rw = torch.exp(-(diff.float() ** 2) / (2 * sigma_r ** 2))
            w = sw * rw
            num += w * nb
            den += w
    return (num / den.clamp(min=1e-12)).to(img.dtype)
