"""The least time each of the port's kernels could take, from its call's
shapes: the larger of two times.

  * Bytes: every input byte read once and every output byte written once,
    over the HBM rate of the H100 SXM (NVIDIA's data sheet, 3.35 TB/s at
    the full 700 W power limit).
  * Operations, for the wrappers in :data:`OPERATIONS`: the arithmetic the
    kernel's algorithm needs a block, as the benchmark's frozen reference
    (``texbench/reference/``) defines that algorithm, over
    :data:`OPS_PER_S`, the data sheet's 67 TFLOP/s of float32 on the CUDA
    cores outside the tensor cores (132 SMs x 128 lanes x 1.98 GHz, a
    fused multiply-add counted as two operations).

An operation is one add, subtract, multiply, divide, min, max, compare,
select, shift, mask, rounding or conversion of one 32-bit value; a
multiply-add is two, as the peak counts it. A value that several pixels,
codewords or candidates share is counted once, where the reference
computes it; data-dependent early exits are not assumed. Two rules give
the least that any implementation of the reference's arithmetic needs:

  * a squared distance of 8-bit colours, |c - p|^2 over three channels,
    is one dot product, two operations: it equals |c|^2 - 2 c.p + |p|^2,
    with |c|^2 once a colour and |p|^2 once a pixel (dot products
    themselves), and one 4-way 8-bit dot product (``__dp4a``) issues at
    half the rate of the float32 lanes' multiply-adds;
  * a top-k selection is one comparison an entry.

Neither count depends on how a kernel is written, so a redesign of a
kernel cannot read above 100% of its time. A redesign that changes the
algorithm (prunes the exhaustive searches while keeping the bytes, or
moves the distances onto the tensor cores) needs its count revisited.

In a traced span :class:`CallRecorder` wraps every kernel wrapper of the
port (``texcomp_torch/ops/*_cuda.py``, the functions named ``*_cuda``),
records the bytes and operations of each call, and counts the device
kernels the call launches, so that the reader can hold the calls to the
kernels the profiler saw.
"""

from __future__ import annotations

import functools
import importlib

import torch

HBM_BYTES_PER_S = 3.35e12
#: The H100 SXM data sheet's float32 rate outside the tensor cores, at
#: 700 W: operations per second, a multiply-add counted as two.
OPS_PER_S = 67e12

#: A multiply-add; also a squared distance or a |c|^2 of 8-bit colours
#: (one dot product, see the module docstring).
MAD = DOT = 2
#: ``util.quantize8``: v * m + 128 (a multiply-add), (i + (i >> 8)) >> 8.
QUANTIZE8 = MAD + 3
#: Compare-exchanges of the best sorting network of 8 values, two
#: operations each (a min and a max).
SORT8 = 19 * 2


def etc1_hq_evaluation_ops() -> int:
    """One candidate pair of subblock bases scored by one flip's
    exhaustive search (``reference/etc._finish_flip``), per block:

      * 14: the mode, ``d555 = q2 - q1`` (3), ``-4 <= d <= 3`` on three
        channels (6), and-ed (5);
      * 42: the decoded bases, per subblock and channel ``extend_5bit``
        (4), ``extend_4bit`` (2) and the mode's select (1): 2 x 3 x 7;
      * 576: the colours ``clamp8(base + modifier)``, an add and two
        clamps, per subblock, codeword, modifier and channel:
        2 x 8 x 4 x 3 x 3;
      * 128: each of those 64 colours' |c|^2 (a dot product);
      * 1,024: the errors ``sum((cand - pixel)^2)`` of 16 pixels against
        their subblock's 8 x 4 colours, a dot product each;
      * 384: per pixel and codeword the least of its 4 modifiers
        (``err.amin(dim=3)``), 3: 16 x 8 x 3;
      * 112: per subblock and codeword the sum over its 8 pixels, 7:
        2 x 8 x 7;
      * 14: per subblock the least of its 8 codewords, 7 (``argmin``);
      * 6: the two subblocks' errors and the pixels' |p|^2 added (2),
        compared with the best so far (1), three values kept (3).
    """
    return (14 + 2 * 3 * 7 + 2 * 8 * 4 * 3 * 3 + 2 * 8 * 4 * DOT
            + 16 * 8 * 4 * DOT + 16 * 8 * 3 + 2 * 8 * 7 + 2 * 7 + 6)


#: ``reference/etc._hq_candidates``' candidates a flip: truncated and
#: rounded averages (2), their clamped-delta variants (2), the +-1
#: neighbourhood (24), the alternating fit's best and runner-up from 3
#: seeds (6), the exhaustive fit's top 2 and 2 constrained re-solves (4)
#: and its clamped variants (2).
ETC1_HQ_CANDIDATES = 2 + 2 + 24 + 3 * 2 + 4 + 2
#: ``reference/etc``'s HQ_REFITS and HQ_PROBES: two chained refits, then
#: 24 +-1 probes around the second, each scored as a candidate.
ETC1_HQ_REFITS, ETC1_HQ_PROBES = 2, 24


def etc1_hq_fit_ops() -> int:
    """Fitting one flip's :data:`ETC1_HQ_CANDIDATES` candidates
    (``reference/etc._hq_candidates``), per block:

      * 48: the subblock averages, per subblock and channel 7 adds and a
        shift; 12 shifts for the truncated pair, 12 ``quantize8`` for the
        rounded one; 24 for its two clamped-delta variants (per channel two
        adds and a clamp of two); 72 for the neighbourhood (24 probes, an
        add and a clamp each);
      * the exhaustive fit (``_cluster_fit_enum_bases``), per subblock:
        the means 3 x (7 + 1), the projections 8 x 5, a sort of 8, the
        prefix sums 7, ``g13`` 165 adds, ``tm`` a multiply and a
        multiply-add for each of the 165 cuts x 8 codewords (1,320
        entries), ``e0 = const - 2 tm`` a multiply-add each, the top 2 one
        comparison each, the 2 bases 3 x 3 each; two ``_quantize_pair`` of
        6 roundings with conversions and 12 ``quantize8``; and each of the
        two constrained re-solves: per channel the window 11 (two adds and
        clamps, two scalings with conversions), ``b_opt`` 1,320, the
        penalty distance 5 a entry and its square (1, then a multiply-add),
        ``e + 8 pen`` a multiply-add an entry, the argmin one comparison
        an entry, and the clamped, rounded and quantized bases 17 a
        channel;
      * the alternating fit (``_cluster_fit_bases``): the float means 48,
        the luminances 16 x 2, each subblock's 2-means seed 153 (its sum 7,
        the threshold 8 x 2, the counts 7 + 1 + 2, two masked channel sums
        of 3 x 15, the numerators 3 x 4, the denominator 2, the floor
        divisions 3 x 3 + 1 and the scaling 3 x 2); per seed (3) and
        codeword (8) two rounds of an assignment (the 2 x 4 x 3 clamped
        colours 3 each, the 16 x 4 float errors 3 differences and a dot of
        5, the least of 4 and its modifier 3 + 3 a pixel) and a refit (48
        residuals, per subblock and channel 7 adds, a scaling and a clamp
        of 2), the last assignment (its 16 least summed, 15, in place of
        the modifiers), and from the second codeword on the best and
        runner-up update (2 compares, 21 selects); and the 6 pairs
        quantized;
      * 24: the exhaustive fit's two clamped variants.
    """
    first = 48 + 12 + 12 * QUANTIZE8 + 24 + 24 * 3
    entries = 165 * 8
    subblock = (3 * (7 + 1) + 8 * 5 + SORT8 + 7 + 165 + entries * (1 + MAD)
                + entries * MAD + entries + 2 * 3 * 3)
    quantize_pair = 6 * 2 + 12 * QUANTIZE8
    window = 2 * 3 + 2 + 3
    constrained = (3 * (window + entries + entries * 5) + entries * (1 + 2 * MAD)
                   + entries * MAD + entries + 3 * 17)
    enum = 2 * subblock + 2 * quantize_pair + 2 * constrained
    split_seed = 7 + 8 * 2 + 7 + 1 + 2 + 2 * 3 * 15 + 3 * 4 + 2 + 3 * 3 + 1 + 3 * 2
    colours = 2 * 4 * 3 * 3
    errors = 16 * 4 * (3 + 1 + 2 * MAD)
    assign_iter = colours + errors + 16 * (3 + 3)
    refit = 16 * 3 + 2 * 3 * (7 + 1 + 2)
    assign_last = colours + errors + 16 * 3 + 15
    seed = 8 * (2 * (assign_iter + refit) + assign_last) + 7 * (2 + 21)
    alternating = 48 + 16 * 2 + 2 * split_seed + 3 * seed + 6 * quantize_pair
    return first + enum + alternating + 24


def etc1_hq_search_ops(candidates: int, fitted: bool) -> int:
    """One flip's HQ search of a block (``reference/etc._hq_search``) over
    ``candidates`` candidates, fitted in the call (:func:`etc1_hq_fit_ops`)
    or read as packed words (unpacking 2 words x 6 fields, a shift and a
    mask each):

      * each candidate, each of the :data:`ETC1_HQ_REFITS` refits and each
        of the :data:`ETC1_HQ_PROBES` probes scored
        (:func:`etc1_hq_evaluation_ops`);
      * 46: the pixels' |p|^2 (16 dot products) and their sums over each
        subblock (2 x 7);
      * 318 a refit (``_refit_bases``): the two codewords 4, the 16
        pixels' modifier indices 6 each, their codeword select and lookup
        2 each, 48 residuals, per subblock and channel a sum of 7, a
        conversion, a scaling, a rounding, a clamp of 2 and a conversion,
        12 ``quantize8``;
      * 399 each time a winner is packed (the candidates' before the
        first refit, the first refit's before the second, and the last):
        its 16 pixels' codeword select 1 and modifier index 14 (4 errors,
        3 mins, 3 selects), the lo word 16 x 5 + 15, the hi word 64;
      * 72: the probes' bases, an add and a clamp of 2 each.
    """
    steps = candidates + ETC1_HQ_REFITS + ETC1_HQ_PROBES
    ops = (steps * etc1_hq_evaluation_ops() + 16 * DOT + 2 * 7
           + ETC1_HQ_REFITS * 318 + (ETC1_HQ_REFITS + 1) * 399
           + ETC1_HQ_PROBES * 3)
    return ops + (etc1_hq_fit_ops() if fitted else candidates * 2 * 6 * 2)


def cluster_topk4_ops(parts: int) -> int:
    """The HQ DXT cluster fit's top 4 of one block over ``parts`` ordered
    cuts (``reference/dxt_hq.cluster_topk4``, 965 cuts of 16 pixels):

      * 37 a cut: ``u = P[c1] + P[c2] + P[c3]`` 2 adds x 3 channels,
        ``A = u.u`` and ``B = Pt.u`` (int32, not 8-bit: a multiply and two
        multiply-adds each, 5), the bf16 hi/lo split of A and of B (a
        conversion, two roundings and a subtract, 4 each), their terms
        ``(qh vh + qh vl) + ql vh`` (a multiply and two multiply-adds, 5
        each), the score's 2 adds and the top-4 comparison;
      * 26 a block: ``T = Pt.Pt`` 5, its split 4 and term 5, and the 4
        picks' 3 conversions each.
    """
    return parts * 37 + 26


def _etc1_hq_search_call(args: tuple, out) -> int:
    pixels, cands = args[0], args[1]
    if cands is None:
        return pixels.shape[0] * etc1_hq_search_ops(ETC1_HQ_CANDIDATES, True)
    return pixels.shape[0] * etc1_hq_search_ops(cands.shape[0], False)


def _cluster_topk4_call(args: tuple, out) -> int:
    return args[0].shape[0] * cluster_topk4_ops(args[1].shape[0])


#: Kernel wrapper -> the operations of one call, from its arguments and
#: results; a wrapper not listed is held to its bytes alone.
OPERATIONS = {"etc1_hq_search_cuda": _etc1_hq_search_call,
              "cluster_topk4_cuda": _cluster_topk4_call}

#: The port's modules of kernel wrappers.
WRAPPER_MODULES = ("texcomp_torch.ops.dxt_cuda", "texcomp_torch.ops.etc_cuda",
                   "texcomp_torch.ops.pvrtc_cuda",
                   "texcomp_torch.ops.dxt_hq_cuda")

#: Every kernel wrapper of the port -> the device kernels one call with
#: work launches (csrc/*.cu): the HQ cluster fit launches its table kernel
#: before the top-4 kernel.
KERNELS_PER_CALL = {
    "dxt1_encode_cuda": 1, "dxt5_encode_cuda": 1, "dxt1_decode_cuda": 1,
    "dxt5_decode_cuda": 1, "dxtc_downsample_cuda": 1,
    "etc1_encode_cuda": 1, "etc1_decode_cuda": 1, "etc1_downsample_cuda": 1,
    "etc1_hq_search_cuda": 1,
    "pvrtc_morph_cuda": 1, "pvrtc_morph_strip_cuda": 1,
    "pvrtc_morph_batched_cuda": 1, "pvrtc_upscale_modulate_cuda": 1,
    "pvrtc_upscale_modulate_halo_cuda": 1, "pvrtc_modes_pack_cuda": 1,
    "pvrtc_modes_pack_strip_cuda": 1,
    "cluster_topk4_cuda": 2,
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def call_bytes(args: tuple, out) -> int:
    """Bytes of one call: its tensor arguments read once and its tensor
    results written once; a tensor passed twice, or a result that is a
    view of another, counts once."""
    seen, total = set(), 0
    for t in (*_tensors(args), *_tensors(out)):
        key = (t.data_ptr(), t.numel() * t.element_size())
        if key not in seen:
            seen.add(key)
            total += key[1]
    return total


def call_least_s(name: str, args: tuple, out) -> float:
    """The least time of one call: the larger of its bytes over the HBM
    rate and its operations (:data:`OPERATIONS`) over :data:`OPS_PER_S`."""
    ops = OPERATIONS[name](args, out) if name in OPERATIONS else 0
    return max(call_bytes(args, out) / HBM_BYTES_PER_S, ops / OPS_PER_S)


class CallRecorder:
    """Context manager: while open, every call of a port kernel wrapper
    appends (name, least seconds, kernels launched) to :attr:`calls`. A
    wrapper that this table does not know is recorded with least seconds
    None, and the reader then reports nothing."""

    def __init__(self):
        self.calls: list[tuple[str, float | None, int]] = []
        self._saved: list[tuple[object, str, object]] = []

    def _wrap(self, name: str, fn):
        @functools.wraps(fn)
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            work = any(t.numel() for t in _tensors(out))
            per = KERNELS_PER_CALL.get(name)
            self.calls.append((name, call_least_s(name, args, out) if per
                               else None, (per or 1) if work else 0))
            return out

        return recorded

    def __enter__(self):
        for modname in WRAPPER_MODULES:
            mod = importlib.import_module(modname)
            for name, fn in list(vars(mod).items()):
                if name.endswith("_cuda") and callable(fn):
                    self._saved.append((mod, name, fn))
                    setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()
        return False

    def least_s(self) -> float | None:
        """Sum of the recorded calls' least times; None if any call was of
        a wrapper this table does not know."""
        if any(t is None for _, t, _ in self.calls):
            return None
        return sum(t for _, t, _ in self.calls)

    def kernels(self) -> int:
        return sum(k for _, _, k in self.calls)
