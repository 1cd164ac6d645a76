"""The HQ PVRTC A/B fit's full-resolution steps: CUDA kernels and plain
twins.

The fit (``codecs.pvrtc_hq``) alternates a hard per-pixel blend weight t
with a conjugate-gradient refit of the stacked low-res A/B images,
(2, nby, nbx, 4) float32, against the linear map

    J (A, B) = (1 - t) up(A) + t up(B),

where ``up`` is the float bilinear wrap upscale (:func:`_make_upscale_f`)
and J's transpose weights a residual by (1 - t, t) and applies the
upscale's transpose (:func:`_make_upscale_t`). Three of its steps touch
full-resolution values; each is a kernel in ``csrc/pvrtc_hq.cu`` with a
wrapper here (``*_cuda``) and a plain PyTorch version (``*_plain``):

  pvrtc_hq_normal  ridge x + J^T (w J x), the CG's normal operator, or,
                   given ``img``, ridge x + J^T (w img), its right-hand
                   side: (2, nby, nbx, 4) -> (2, nby, nbx, 4).
  pvrtc_hq_dot     <x, y> of two stacked A/B pairs: each leaf's
                   :func:`_ordered_sum` of the products, then A's plus
                   B's, a 0-d tensor.
  pvrtc_hq_choose  the blend weight of each pixel, (H, W) float32: the
                   first of ``_T`` (t = 0 scoring 0) whose squared RGBA
                   error against the upscaled A/B is strictly lowest.

The block shape is what the shapes say: (H / nby, W / nbx), 4x4 for 4bpp
and 4x8 for 2bpp. The twins are the fit's PyTorch ops, every product and
every add its own eager op (no fused multiply-add, no ``alpha=``, no
autograd, no ``torch.sum`` on floats), so they give the same bits on every
device; the kernels give the twins' bits. Every scalar stays a tensor on
the device, so nothing waits on it.

The steps dispatch by the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. No path falls back
from one to the other.
"""

from __future__ import annotations

import torch

from texcomp_torch.codecs import pvrtc as pv
from texcomp_torch.ops._launch import check as _check
from texcomp_torch.ops._launch import launch as _launch
from texcomp_torch.ops._launch import pick as _pick

# Ridge anchoring texels whose bilinear support is all-mod-0/3, as the
# float32 value texcomp computes with.
_RIDGE = 0.009999999776482582  # float32(1e-2)

# Blend weight of B for each modulation value (ApplyModulation,
# pvrtc_compressor.cc:120-144).
_T = (0.0, 3.0 / 8.0, 5.0 / 8.0, 1.0)

#: Block shapes (rows, columns) the kernels are built for.
_BLOCKS = ((4, 4), (4, 8))
#: The dot's plan, as csrc/pvrtc_hq.cu runs it: while a leaf has more than
#: ``_DOT_LAST`` values, a pass reduces each ``_DOT_PER`` of them to one;
#: one last pass reduces the rest.
_DOT_PER = 16
_DOT_LAST = 256 * 64


def _make_upscale_f(h: int, w: int, block_h: int, block_w: int):
    """Float bilinear wrap upscale of (..., nby, nbx, C) low-res images to
    (..., h, w, C): the integer upscale's two separable passes
    (``pvrtc._upscale_axis``), then a true division."""
    def upscale_f(low: torch.Tensor) -> torch.Tensor:
        tmp = pv._upscale_axis(low, w, axis=-2, block=block_w)
        full = pv._upscale_axis(tmp, h, axis=-3, block=block_h)
        return full / float(block_w * block_h)
    return upscale_f


def _upscale_axis_t(g: torch.Tensor, axis: int, block: int) -> torch.Tensor:
    """Transpose of one ``pvrtc._upscale_axis`` pass along ``axis`` (< 0).
    The pass is (block - fw) roll(repeat(x), block/2) + fw roll(repeat(x),
    block/2 - block): weight each term, roll it back, add the two, then add
    each group of ``block`` entries, in order."""
    size = g.shape[axis]
    shape = [1] * g.dim()
    shape[axis] = size
    fw = ((torch.arange(size, device=g.device) + block // 2)
          & (block - 1)).reshape(shape).to(g.dtype)
    half = block // 2
    up = (g * (block - fw)).roll(-half, dims=axis) + (g * fw).roll(
        block - half, dims=axis)
    groups = up.unflatten(axis, (size // block, block))
    out = groups.select(axis, 0)
    for k in range(1, block):
        out = out + groups.select(axis, k)
    return out


def _make_upscale_t(block_h: int, block_w: int):
    """Transpose of :func:`_make_upscale_f`'s map: (..., h, w, C) ->
    (..., nby, nbx, C), its passes in reverse order."""
    def upscale_t(full: torch.Tensor) -> torch.Tensor:
        g = full / float(block_w * block_h)
        tmp = _upscale_axis_t(g, -3, block_h)
        return _upscale_axis_t(tmp, -2, block_w)
    return upscale_t


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Float sum over the last dim as a halving tree of elementwise adds
    (x = x[:n/2] + x[n/2:], zero-padded to a power of two): one order, so
    the same bits on every device."""
    n = x.shape[-1]
    size = 1 << (n - 1).bit_length()
    if size != n:
        x = torch.nn.functional.pad(x, (0, size - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _channel_sum(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (...): c0 + c1 + c2 + c3, in that order."""
    return x[..., 0] + x[..., 1] + x[..., 2] + x[..., 3]


def _tree_axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """alpha * x + y as a multiply and then an add."""
    return alpha * x + y


def _block_shape(low: torch.Tensor, h: int, w: int) -> tuple:
    """(block rows, block columns) of (..., nby, nbx, 4) texels upscaled to
    (h, w)."""
    return h // low.shape[-3], w // low.shape[-2]


def pvrtc_hq_normal_plain(x: torch.Tensor, t: torch.Tensor,
                          img: torch.Tensor | None = None) -> torch.Tensor:
    """ridge x + J^T (w J x), or with ``img`` ridge x + J^T (w img), for
    the blend weights ``t`` (H, W): the weights (1 - t, t), the forward map
    and its transpose as the fit's PyTorch ops."""
    h, w = t.shape
    bh, bw = _block_shape(x, h, w)
    tb = t[..., None]
    weights = torch.stack([1.0 - tb, tb])
    if img is None:
        up = _make_upscale_f(h, w, bh, bw)(x)
        img = weights[0] * up[0] + weights[1] * up[1]
    return _tree_axpy(_RIDGE, x, _make_upscale_t(bh, bw)(weights * img))


def pvrtc_hq_dot_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> of two stacked (A, B) pairs: each leaf's ordered sum, then
    A's plus B's. A 0-d tensor."""
    leaves = _ordered_sum((x * y).flatten(1))
    return leaves[0] + leaves[1]


def pvrtc_hq_choose_plain(img_f: torch.Tensor,
                          ab: torch.Tensor) -> torch.Tensor:
    """Hard per-pixel blend weight by squared error against the upscaled
    A/B, |d - t e|^2 - |d|^2 = t^2 |e|^2 - 2 t (d.e) with d = img - up(A),
    e = up(B) - up(A), over the strict-< chain of ``_T[1:]`` (t = 0 scores
    0). (H, W) float32."""
    h, w = img_f.shape[:2]
    up = _make_upscale_f(h, w, *_block_shape(ab, h, w))(ab)
    d = img_f - up[0]
    e = up[1] - up[0]
    s = _channel_sum(d * e)
    q = _channel_sum(e * e)
    best_t = torch.zeros_like(s)
    best_e = torch.zeros_like(s)
    for tv in _T[1:]:
        cand = (tv * tv) * q - (2.0 * tv) * s
        better = cand < best_e
        best_t = torch.where(better, tv, best_t)
        best_e = torch.where(better, cand, best_e)
    return best_t


def _check_low(x: torch.Tensor, name: str, h: int, w: int) -> tuple:
    """Raise unless ``x`` is a (2, nby, nbx, 4) float32 A/B pair whose
    texels upscale to (h, w) by a block shape the kernels take; return
    (nby, nbx, block rows, block columns)."""
    ok = x.dim() == 4 and x.shape[0] == 2 and x.shape[3] == 4
    nby, nbx = (x.shape[1], x.shape[2]) if ok else (0, 0)
    ok = ok and nby > 0 and nbx > 0 and h % nby == 0 and w % nbx == 0
    block = (h // nby, w // nbx) if ok else None
    _check(x, name, ok and block in _BLOCKS, 16, torch.float32)
    return (nby, nbx, *block)


def pvrtc_hq_normal_cuda(x: torch.Tensor, t: torch.Tensor,
                         img: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel version of :func:`pvrtc_hq_normal_plain`."""
    _check(t, "pvrtc_hq_normal", t.dim() == 2, 4, torch.float32)
    h, w = t.shape
    nby, nbx, bh, bw = _check_low(x, "pvrtc_hq_normal", h, w)
    if img is not None:
        _check(img, "pvrtc_hq_normal", tuple(img.shape) == (h, w, 4), 16,
               torch.float32)
    out = torch.empty_like(x)
    _launch("pvrtc_hq_normal", x.device, "texcomp_pvrtc_hq_normal",
            x.data_ptr(), t.data_ptr(),
            None if img is None else img.data_ptr(), nby, nbx, bh, bw,
            out.data_ptr())
    return out


def dot_scratch_floats(n: int) -> int:
    """Floats of scratch the dot kernel's passes write for ``n`` values a
    leaf (its plan in csrc/pvrtc_hq.cu)."""
    m, total = 1 << (n - 1).bit_length(), 0
    while m > _DOT_LAST:
        m //= _DOT_PER
        total += 2 * m
    return total


def pvrtc_hq_dot_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Kernel version of :func:`pvrtc_hq_dot_plain`."""
    ok = x.dim() >= 1 and x.shape[0] == 2 and x.numel() > 0
    _check(x, "pvrtc_hq_dot", ok, 4, torch.float32)
    _check(y, "pvrtc_hq_dot", y.shape == x.shape, 4, torch.float32)
    n = x.numel() // 2
    if n > 1 << 30:
        raise ValueError(f"pvrtc_hq_dot: {n} values a leaf is too many")
    floats = dot_scratch_floats(n)
    scratch = torch.empty(max(floats, 1), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    _launch("pvrtc_hq_dot", x.device, "texcomp_pvrtc_hq_dot", x.data_ptr(),
            y.data_ptr(), n, scratch.data_ptr(), floats, out.data_ptr())
    return out


def pvrtc_hq_choose_cuda(img_f: torch.Tensor,
                         ab: torch.Tensor) -> torch.Tensor:
    """Kernel version of :func:`pvrtc_hq_choose_plain`."""
    _check(img_f, "pvrtc_hq_choose",
           img_f.dim() == 3 and img_f.shape[2] == 4, 16, torch.float32)
    h, w = img_f.shape[:2]
    nby, nbx, bh, bw = _check_low(ab, "pvrtc_hq_choose", h, w)
    out = torch.empty((h, w), dtype=torch.float32, device=img_f.device)
    _launch("pvrtc_hq_choose", img_f.device, "texcomp_pvrtc_hq_choose",
            img_f.data_ptr(), ab.data_ptr(), nby, nbx, bh, bw,
            out.data_ptr())
    return out


def pvrtc_hq_normal(x: torch.Tensor, t: torch.Tensor,
                    img: torch.Tensor | None = None) -> torch.Tensor:
    """The fit's normal operator, or with ``img`` its right-hand side (see
    the module docstring), on ``x``'s device."""
    return _pick(x, pvrtc_hq_normal_plain, pvrtc_hq_normal_cuda)(x, t, img)


def pvrtc_hq_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> in the halving-tree order, on ``x``'s device."""
    return _pick(x, pvrtc_hq_dot_plain, pvrtc_hq_dot_cuda)(x, y)


def pvrtc_hq_choose(img_f: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """Each pixel's blend weight against the upscaled A/B, on the image's
    device."""
    return _pick(img_f, pvrtc_hq_choose_plain, pvrtc_hq_choose_cuda)(img_f, ab)
