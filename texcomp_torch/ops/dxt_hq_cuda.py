"""The HQ DXT cluster-fit top 4: CUDA kernel and plain twin.

For each 4x4 block, ``cluster_topk4`` scores every partition of the
cluster-fit table (``codecs.dxt_hq._cf_tables_np``: 965 ordered cuts of
the 16 axis-sorted pixels) from the block's descending prefix sums and
keeps the 4 best, in descending score order, ties to the lower partition
index. Each pick is returned as its payload (u0, u1, u2, alpha, beta,
delta): u = P[c1] + P[c2] + P[c3] per channel (exact integers) and the
partition's closed-form constants; ``codecs.dxt_hq`` turns a payload into
quantized endpoints.

The score of a partition is exact integer algebra up to one float32 tree:
with A = u.u, B = u.Pt, T = Pt.Pt (int32; at most 4.5e8),

    score = (term(quu, A) + term(qut, B)) + term(qtt, T)
    term(q, v) = (q_h * v_h + q_h * v_l) + q_l * v_h

where q_h + q_l and v_h + v_l are bf16 hi/lo splits (round to nearest
even): every product is exact, so the tree is the same on every device.

``cluster_topk4`` runs the kernel (``csrc/dxt_hq.cu``) on a CUDA tensor and
the plain twin on a CPU tensor; no path falls back from one to the other.
"""

from __future__ import annotations

import torch

from texcomp_torch.ops._launch import check as _check
from texcomp_torch.ops._launch import launch as _launch
from texcomp_torch.ops._launch import pick as _pick

#: The kernel's packed table holds at most every ordered cut.
_MAX_PARTS = 969


def cf_score(a_i, b_i, ptt_i, quu_h, quu_l, qut_h, qut_l, qtt_h, qtt_l):
    """The cluster-fit score of int32 ``a_i``, ``b_i``, ``ptt_i`` against
    the bf16 hi/lo-split constants, in the fixed float32 tree above."""
    def split(v):
        vf = v.to(torch.float32)
        vh = vf.to(torch.bfloat16).to(torch.float32)
        return vh, (vf - vh).to(torch.bfloat16).to(torch.float32)

    def term(qh, ql, v):
        vh, vl = split(v)
        return (qh * vh + qh * vl) + ql * vh

    return ((term(quu_h, quu_l, a_i) + term(qut_h, qut_l, b_i))
            + term(qtt_h, qtt_l, ptt_i))


def _argmax_first(score: torch.Tensor) -> torch.Tensor:
    """First index of the maximum along dim 1."""
    top = score.amax(dim=1, keepdim=True)
    idx = torch.arange(score.shape[1], device=score.device)
    return torch.where(score == top, idx, score.shape[1]).amin(dim=1)


def cluster_topk4_plain(prefix: torch.Tensor, cuts: torch.Tensor,
                        qtab: torch.Tensor) -> torch.Tensor:
    """(N, 17, 3) int32 prefix sums, (P, 3) int32 cuts, (P, 9) float32
    constants -> (N, 4, 6) float32 payloads: every partition scored, then
    4 rounds of first-occurrence argmax, each masking its pick."""
    p = prefix.to(torch.int32)
    pt = p[:, 16, :]
    uc = [p[:, cuts[:, 0], c] + p[:, cuts[:, 1], c] + p[:, cuts[:, 2], c]
          for c in range(3)]  # 3 x (N, P) exact integers
    a_i = uc[0] * uc[0] + uc[1] * uc[1] + uc[2] * uc[2]
    b_i = pt[:, 0:1] * uc[0] + pt[:, 1:2] * uc[1] + pt[:, 2:3] * uc[2]
    ptt_i = (pt[:, 0] * pt[:, 0] + pt[:, 1] * pt[:, 1]
             + pt[:, 2] * pt[:, 2])[:, None]
    q = [qtab[None, :, j] for j in range(6)]
    score = cf_score(a_i, b_i, ptt_i, *q)
    picks = []
    for _ in range(4):
        k = _argmax_first(score)
        score = score.scatter(1, k[:, None], float("-inf"))
        u = [torch.gather(c, 1, k[:, None]).to(torch.float32) for c in uc]
        picks.append(torch.cat(u + [qtab[k, 6:9]], dim=1))
    return torch.stack(picks, dim=1)


def cluster_topk4_cuda(prefix: torch.Tensor, cuts: torch.Tensor,
                       qtab: torch.Tensor) -> torch.Tensor:
    """Kernel version of :func:`cluster_topk4_plain`."""
    _check(prefix, "dxt_hq_cluster_topk4",
           prefix.dim() == 3 and tuple(prefix.shape[1:]) == (17, 3), 4,
           torch.int32)
    n_parts = cuts.shape[0]
    _check(cuts, "dxt_hq_cluster_topk4", cuts.shape == (n_parts, 3)
           and 4 <= n_parts <= _MAX_PARTS, 4, torch.int32)
    _check(qtab, "dxt_hq_cluster_topk4", qtab.shape == (n_parts, 9), 4,
           torch.float32)
    n = prefix.shape[0]
    out = torch.empty((n, 4, 6), dtype=torch.float32, device=prefix.device)
    if n:
        _launch("dxt_hq_cluster_topk4", prefix.device,
                "texcomp_dxt_hq_cluster_topk4", prefix.data_ptr(), n,
                cuts.data_ptr(), qtab.data_ptr(), n_parts, out.data_ptr())
    return out


def cluster_topk4(prefix: torch.Tensor, cuts: torch.Tensor,
                  qtab: torch.Tensor) -> torch.Tensor:
    """The top-4 partitions of each block (see the module docstring), on
    the prefix sums' device."""
    fn = _pick(prefix, cluster_topk4_plain, cluster_topk4_cuda)
    return fn(prefix, cuts, qtab)
