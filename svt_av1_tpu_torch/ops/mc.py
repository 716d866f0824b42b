"""Inter prediction helpers (AV1 convolve semantics) — port of the parts
of svt_av1_tpu/ops/mc.py that the P and B steps run: the 8-tap
interpolation kernels, the reference-plane padding and the compound
(COMPOUND_AVERAGE) constants and average.

The per-block subpel filtering itself lives next to its callers in
pipeline/inter_encoder.py (``_phase_grid``, ``_interp_patch``), which
reproduce ref av1_convolve_{x,y,2d}_sr_c rounding case for case and,
for compound blocks, the CONV_BUF-domain av1_jnt_convolve_2d_c output.
"""

from __future__ import annotations

import functools

import torch

from svt_av1_tpu_torch import tables

# frame-level interpolation_filter enum (spec 6.8.9 / ref EbDefinitions.h
# InterpFilter): 0=EIGHTTAP_REGULAR, 1=EIGHTTAP_SMOOTH, 2=EIGHTTAP_SHARP
FILTER_TABLES = ("subpel_filters_regular", "subpel_filters_smooth",
                 "subpel_filters_sharp")

FILTER_BITS = 7
ROUND0 = 3          # 8-bit conv params round_0 (ref get_conv_params)
# compound (jnt) convolve: round_1 = 7, CONV_BUF intermediate (ref
# av1_jnt_convolve_2d_c, EbInterPrediction.c:267)
JNT_ROUND1 = 7
JNT_ROUND_BITS = 2 * FILTER_BITS - ROUND0 - JNT_ROUND1   # 4


@functools.lru_cache(maxsize=None)
def kernel(phase: int, filt: int = 0) -> tuple:
    """8-tap kernel for subpel phase 0..15 of one interp filter (spec
    Subpel_Filters; ref sub_pel_filters_8/8smooth/8sharp,
    EbInterPrediction.c:867-903)."""
    k = tables.spec_tables()[FILTER_TABLES[filt]][phase]
    return tuple(int(v) for v in k)


def pixel_dtype(bd: int) -> torch.dtype:
    """The device container of bd-bit pixels: uint8 at 8 bits, int16 at
    10 (torch's uint16 has no arithmetic or comparisons; 10-bit values
    fit int16, and the host converts to and from numpy uint16)."""
    return torch.uint8 if bd == 8 else torch.int16


def pad_for_filter(plane, pad: int):
    """Edge-replicate pad by (pad+3) left/top and (pad+4) right/bottom,
    as int32.

    ``pad`` is the motion search range in pixels; +3/+4 is the 8-tap
    halo.  Gathers into the result at [y+pad+3, x+pad+3] + mv stay in
    bounds for |mv| <= pad.  Mirrors the reference's reference-picture
    border extension (ref EbPictureBufferDesc padding + clamp_mv_ref).
    """
    return edge_pad(plane.to(torch.int32), pad + 3, pad + 4, pad + 3,
                    pad + 4)


def edge_pad(plane, top: int, bottom: int, left: int, right: int):
    """Edge-replicate pad of the last two dims (np.pad mode="edge"); any
    leading dims (a batch of frames) pass through."""
    h, w = plane.shape[-2:]
    rows = torch.arange(-top, h + bottom, device=plane.device).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=plane.device).clamp(0, w - 1)
    return plane[..., rows[:, None], cols[None, :]]


def jnt_round_offset(bd: int = 8) -> int:
    """The compound offset that CONV_BUF values carry (6144 at 8-bit)."""
    ob = bd + 2 * FILTER_BITS - ROUND0
    return (1 << (ob - JNT_ROUND1)) + (1 << (ob - JNT_ROUND1 - 1))


def jnt_average(res0, res1, bd: int = 8):
    """COMPOUND_AVERAGE of two CONV_BUF blocks -> pixels (ref
    av1_jnt_convolve_*_c do_average path, use_jnt_comp_avg=0)."""
    tmp = ((res0 + res1) >> 1) - jnt_round_offset(bd)
    return torch.clamp((tmp + (1 << (JNT_ROUND_BITS - 1)))
                       >> JNT_ROUND_BITS, 0, (1 << bd) - 1)
