"""Quantization / dequantization in PyTorch.

Port of svt_av1_tpu/ops/quant.py.  Dequant is normative (spec
7.12.2-7.12.3): ``(|level| * q) >> tx_scale``, sign after, clamped to the
(bd+8)-bit range.  Quantize is the reference encoder's f32 deadzone
quantizer: ``floor((|coeff| << shift) + rnd) * (1/q))`` — copied exactly
(an integer division would give different levels).

``qindex`` is a Python int (one q for the frame) or an integer tensor
of per-block qindex values broadcast as ``[..., 1, 1]``.
"""

from __future__ import annotations

import functools

import torch

from svt_av1_tpu_torch import tables
from svt_av1_tpu_torch.ops.transforms import TX_H, TX_W


def tx_scale(tx_size: int) -> int:
    """(pels > 256) + (pels > 1024) — spec av1_get_tx_scale."""
    pels = TX_W[tx_size] * TX_H[tx_size]
    return int(pels > 256) + int(pels > 1024)


@functools.lru_cache(maxsize=None)
def quant_params(qindex: int, bd: int = 8) -> tuple[int, int]:
    """(dc_q, ac_q) step sizes (zero delta_q, as the reference's CQP path)."""
    return tables.dc_q(qindex, bd), tables.ac_q(qindex, bd)


@functools.lru_cache(maxsize=None)
def _lookup(bd: int, device: torch.device):
    t = tables.spec_tables()
    return (torch.as_tensor(t[f"dc_qlookup_{bd}"].astype("int32"),
                            device=device),
            torch.as_tensor(t[f"ac_qlookup_{bd}"].astype("int32"),
                            device=device))


def _qgrids(qindex, tx_size: int, bd: int, device: torch.device):
    """(q, rnd, lvl_max, shift): q/rnd/lvl_max are int32 tensors that
    broadcast against [..., H, W] level blocks.  The per-frame path
    uses the reference's traced-q branch (no int8 level cap)."""
    w, h = TX_W[tx_size], TX_H[tx_size]
    shift = tx_scale(tx_size)
    dc_t, ac_t = _lookup(bd, device)
    if isinstance(qindex, int):
        dc, ac = dc_t[qindex], ac_t[qindex]
    else:
        qi = qindex.to(device=device, dtype=torch.long)
        dc, ac = dc_t[qi][..., None, None], ac_t[qi][..., None, None]
    pos0 = torch.zeros((h, w), dtype=torch.bool, device=device)
    pos0[0, 0] = True
    q = torch.where(pos0, dc, ac)
    rnd = torch.where(pos0, dc // 2, (ac * 7) >> 4)
    hi = ((1 << (bd + 7)) - 1) << shift
    lvl_max = torch.minimum(torch.where(pos0, hi // dc, hi // ac),
                            torch.tensor(1 << 30, dtype=torch.int32,
                                         device=device))
    return q, rnd, lvl_max, shift


def quantize_batch(coeffs, qindex, tx_size: int, bd: int = 8):
    """coeffs [..., H, W] int32 -> levels [..., H, W] int32 (signed).

    Deadzone rounding of 7/16 (AC) and 1/2 (DC), like the reference's
    default quantize_b rounding split."""
    q, rnd, lvl_max, shift = _qgrids(qindex, tx_size, bd, coeffs.device)
    mag = coeffs.abs().to(torch.int32) << shift
    lvl = (mag + rnd).to(torch.float32) * (1.0 / q.to(torch.float32))
    lvl = torch.floor(lvl).to(torch.int32)
    lvl = torch.minimum(lvl, lvl_max)
    return torch.sign(coeffs).to(torch.int32) * lvl


def dequantize_batch(levels, qindex, tx_size: int, bd: int = 8):
    """Exact normative dequant: [..., H, W] levels -> int32 coefficients."""
    q, _rnd, _lm, shift = _qgrids(qindex, tx_size, bd, levels.device)
    mag = (levels.abs().to(torch.int32) * q) >> shift
    mag = torch.clamp(mag, max=(1 << (bd + 7)) - 1)
    return torch.sign(levels).to(torch.int32) * mag
