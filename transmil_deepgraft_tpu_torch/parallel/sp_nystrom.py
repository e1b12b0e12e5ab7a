"""Sequence-parallel Nystrom attention over the mesh's ``sp`` dim (port of
``parallel/sp_nystrom.py``).

The tokens split contiguously over the ``sp`` processes, each holding its
segment of q, k and v (b, h, n/sp, d):

- landmarks: each process takes its m/sp local segment means; one
  ``all_gather`` (m x d, q's and k's together) gives every process all m;
- the landmark softmax and the Newton-Schulz pinv run on every process
  (m x m, small);
- ``attn3 @ v``: the local landmark attention over this segment's keys gives
  the normalised rows and each row's log-sum-exp; the landmark-to-token
  softmax then normalises across processes with an ``all_reduce`` (MAX) of
  the log-sum-exps and one ``all_reduce`` (SUM) of the rescaled rows and
  their weights (JAX's ``pmax``/``psum`` pair, in log-sum-exp form);
- the output rows stay with their segment: ``softmax(q k_lm^T) B`` with
  ``B = pinv @ attn3_v``.

On the card, at the kernels' shape (256 landmarks, dim_head 64), the local
landmark attention is B3 (``ops/nystrom_kernel.landmark_attention`` with its
row statistics) and the output rows B4 (``query_landmark_attention``); at any
other shape both are the plain formula. The choice is made by shape alone,
before anything runs, never on a failure. Forward only: the kernels carry no
gradient here, as the JAX function is never differentiated in its package.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from transmil_deepgraft_tpu_torch.ops import nystrom_kernel as nk
from transmil_deepgraft_tpu_torch.ops.pinv import newton_schulz_pinv
from transmil_deepgraft_tpu_torch.parallel.mesh import axis_size


def _all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order (the
    list form of ``all_gather``, which gloo also runs on CUDA tensors)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def sp_nystrom_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    num_landmarks: int = 256,
    pinv_iterations: int = 6,
) -> torch.Tensor:
    """Nystrom attention with the token axis split over mesh dim ``sp``.

    q, k, v: this process's contiguous segment (b, h, n/sp, d) of the
    sequence, in the ``sp`` order of the mesh; the whole sequence's n must be
    a multiple of ``num_landmarks`` whose segment length n/m divides n/sp,
    and ``num_landmarks % sp == 0``. Returns this segment's (b, h, n/sp, d)
    float32 output rows: ``ops.nystrom.nystrom_attention(...).out`` of the
    whole sequence, cut to the segment."""
    b, h, n_loc, d = q.shape
    m = num_landmarks
    sp = axis_size(mesh, "sp")
    n = n_loc * sp
    if m % sp != 0:
        raise ValueError(f"num_landmarks {m} must divide over sp={sp}")
    if n % m != 0 or (n // sp) % (n // m) != 0:
        raise ValueError(
            f"token count {n} must be a multiple of landmarks {m}, with segment "
            f"length n/m dividing the shard size n/sp"
        )
    group = mesh.get_group("sp")
    seg = n // m
    m_loc = n_loc // seg
    qs = q.float() * d ** -0.5
    kf, vf = k.float(), v.float()

    lm_loc = torch.stack([qs.reshape(b, h, m_loc, seg, d).mean(dim=3),
                          kf.reshape(b, h, m_loc, seg, d).mean(dim=3)])
    q_lm, k_lm = _all_gather_cat(lm_loc, group, dim=3)  # (b, h, m, d) each

    attn2 = torch.softmax(q_lm @ k_lm.transpose(-1, -2), dim=-1)
    attn2_inv = newton_schulz_pinv(attn2, pinv_iterations)

    # this segment's landmark attention, normalised, and its rows' log-sum-exp
    kernels = m == nk.KERNEL_LANDMARKS and d == nk.KERNEL_DIM_HEAD
    if kernels:
        part, lse = nk.landmark_attention(q_lm.reshape(b * h, m, d).contiguous(),
                                          kf.reshape(b * h, n_loc, d),
                                          vf.reshape(b * h, n_loc, d), return_stats=True)
        part, lse = part.reshape(b, h, m, d), lse.reshape(b, h, m)
    else:
        part, lse = nk.landmark_attention_reference(q_lm, kf, vf, return_stats=True)
    # the softmax over all n keys: rows weighted by exp(lse - the global max)
    top = lse.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(lse - top)
    merged = torch.cat([(part * w[..., None]).reshape(b, h, m * d), w], dim=-1)
    dist.all_reduce(merged, group=group)
    attn3_v = merged[..., :m * d].reshape(b, h, m, d) / merged[..., m * d:, None]

    bmat = attn2_inv @ attn3_v
    if kernels:
        out = nk.query_landmark_attention(qs.reshape(b * h, n_loc, d),
                                          k_lm.reshape(b * h, m, d).contiguous(),
                                          bmat.reshape(b * h, m, d).contiguous())
        return out.reshape(b, h, n_loc, d)
    attn1 = torch.softmax(qs @ k_lm.transpose(-1, -2), dim=-1)
    return (attn1 @ attn2_inv) @ attn3_v
