"""Plain-PyTorch oracle for flash attention: the unblocked softmax in
f32 (the reference's ``attention_ref``, which is also its default
implementation off the TPU), with ``jax.nn.softmax``'s formula."""
import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (BH, T, d); k/v: (BH, S, d)."""
    d = q.shape[-1]
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) * d ** -0.5
    if causal:
        T, S = s.shape[1], s.shape[2]
        mask = (torch.arange(S, device=q.device)[None, :]
                <= torch.arange(T, device=q.device)[:, None])
        s = torch.where(mask[None], s, -1e30)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    w = e / e.sum(-1, keepdim=True)
    return torch.einsum("bts,bsd->btd", w, v.float()).to(q.dtype)
