"""AV1 integer transforms in PyTorch — the batched stage engine.

Port of svt_av1_tpu/ops/transforms.py.  The 19 tx sizes x 16 tx types
run on ONE vectorized butterfly engine that executes the normative stage
tables (tables/data/txfm_stages.json) over ``[..., N]`` tensors:

  * ``inv_txfm2d_batch`` — the normative inverse, bit-exact in int32
    (the spec's per-stage clamps bound every product below 2^31);
  * ``fwd_txfm2d_batch_exact`` — the exact integer forward (intra path);
  * ``fwd_txfm2d_batch`` — the f32 matrix forward of the inter path.
    Its two products are written as explicit multiply-and-add sweeps in
    a fixed order (not ``torch.matmul``), so the CPU and the GPU round
    every partial sum identically and the levels agree bit for bit
    across devices.  Against the reference's XLA einsum the order
    differs, which can flip a ``round`` at .5 (logged in ROADMAP.md).

All three keep the reference's layout: ``[..., H, W]`` blocks in, the
same shape out, on the input's device.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np
import torch

from svt_av1_tpu_torch.tables import cospi_arr

# --- tx size enum (AV1 spec order, = reference TX_SIZES_ALL) ----------------
TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64 = 0, 1, 2, 3, 4
TX_4X8, TX_8X4, TX_8X16, TX_16X8 = 5, 6, 7, 8
TX_16X32, TX_32X16, TX_32X64, TX_64X32 = 9, 10, 11, 12
TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16 = 13, 14, 15, 16, 17, 18
TX_SIZES_ALL = 19

TX_W = [4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64]
TX_H = [4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16]

# fwd/inv rounding shifts per size (spec; ref EbTransforms.h:121-139/:268-286)
FWD_SHIFT = [
    (2, 0, 0), (2, -1, 0), (2, -2, 0), (2, -4, 0), (0, -2, -2),
    (2, -1, 0), (2, -1, 0), (2, -2, 0), (2, -2, 0), (2, -4, 0), (2, -4, 0),
    (0, -2, -2), (2, -4, -2), (2, -1, 0), (2, -1, 0), (2, -2, 0), (2, -2, 0),
    (0, -2, 0), (2, -4, 0),
]
INV_SHIFT = [
    (0, -4), (-1, -4), (-2, -4), (-2, -4), (-2, -4),
    (0, -4), (0, -4), (-1, -4), (-1, -4), (-1, -4), (-1, -4),
    (-1, -4), (-1, -4), (-1, -4), (-1, -4), (-2, -4), (-2, -4),
    (-2, -4), (-2, -4),
]
# fwd cos bits [log2(w)-2][log2(h)-2] (spec; ref EbTransforms.h:141-156)
FWD_COS_BIT_COL = [
    [13, 13, 13, 0, 0],
    [13, 13, 13, 12, 0],
    [13, 13, 13, 12, 13],
    [0, 13, 13, 12, 13],
    [0, 0, 13, 12, 13],
]
FWD_COS_BIT_ROW = [
    [13, 13, 12, 0, 0],
    [13, 13, 13, 12, 0],
    [13, 13, 12, 13, 12],
    [0, 12, 13, 12, 11],
    [0, 0, 12, 11, 10],
]
INV_COS_BIT = 12

NEW_SQRT2 = 5793        # 2^12 * sqrt(2)
NEW_INV_SQRT2 = 2896    # 2^12 / sqrt(2)
NEW_SQRT2_BITS = 12

# --- tx types (AV1 spec enum order) -----------------------------------------
DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST = 0, 1, 2, 3
FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST = 4, 5, 6
ADST_FLIPADST, FLIPADST_ADST, IDTX = 7, 8, 9
V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST = 10, 11, 12, 13, 14, 15
TX_TYPES = 16

_D, _A, _F, _I = 0, 1, 2, 3  # 1-D kinds: DCT, ADST, FLIPADST, IDENTITY
# (vertical kind, horizontal kind) per tx type
_VH = [
    (_D, _D), (_A, _D), (_D, _A), (_A, _A), (_F, _D), (_D, _F), (_F, _F),
    (_A, _F), (_F, _A), (_I, _I), (_D, _I), (_I, _D), (_A, _I), (_I, _A),
    (_F, _I), (_I, _F),
]

_IDENTITY_MULT = {4: (NEW_SQRT2, True), 8: (2, False),
                  16: (2 * NEW_SQRT2, True), 32: (4, False),
                  64: (4 * NEW_SQRT2, True)}


def flip_cfg(tx_type: int) -> tuple[bool, bool]:
    """(ud_flip, lr_flip) — spec get_flip_cfg."""
    v, h = _VH[tx_type]
    return v == _F, h == _F


def round_shift(x, bit: int):
    """(x + 2^(bit-1)) >> bit, arithmetic shift (spec round2)."""
    return (x + (1 << (bit - 1))) >> bit


def _round_shift_array(x, bit: int):
    """ref av1_round_shift_array_c: bit>0 rounds right, bit<0 shifts left."""
    if bit == 0:
        return x
    if bit > 0:
        return round_shift(x, bit)
    return x * (1 << -bit)


def _clamp(x, bit: int):
    if bit <= 0:
        return x
    return torch.clamp(x, -(1 << (bit - 1)), (1 << (bit - 1)) - 1)


# --- stage tables (host numpy, shared with the reference's layout) ----------

_STAGES_PATH = Path(__file__).parents[1] / "tables/data/txfm_stages.json"


@functools.lru_cache(maxsize=1)
def _raw_stage_tables() -> dict:
    return json.loads(_STAGES_PATH.read_text())


@functools.lru_cache(maxsize=None)
def compiled_stages(key: str, cos_bit: int):
    """Compile a stage table into numpy arrays for vectorized execution.

    Returns list of (a, b, wa, wb, is_mul, is_add) per stage, where lane i
    computes  y[i] = wa[i]*x[a[i]] + wb[i]*x[b[i]],  then rounds by cos_bit
    if is_mul[i], and (inverse only) clamps if is_add[i].
    """
    cospi = cospi_arr(cos_bit)
    out = []
    for stage in _raw_stage_tables()[key]:
        n = len(stage)
        a = np.zeros(n, np.int32)
        b = np.zeros(n, np.int32)
        wa = np.zeros(n, np.int64)
        wb = np.zeros(n, np.int64)
        is_mul = np.zeros(n, bool)
        is_add = np.zeros(n, bool)
        for i, lane in enumerate(stage):
            kind, ai, bi, x, y = lane
            a[i], b[i] = ai, bi
            if kind == "m":
                wa[i] = x[0] * int(cospi[x[1]])
                wb[i] = y[0] * int(cospi[y[1]])
                is_mul[i] = True
            elif kind == "a":
                wa[i], wb[i] = x, y
                is_add[i] = True
            else:  # copy
                wa[i], wb[i] = x, 0
        out.append((a, b, wa, wb, is_mul, is_add))
    return out


@functools.lru_cache(maxsize=None)
def _stages_on(key: str, cos_bit: int, device: torch.device):
    """compiled_stages as tensors on ``device`` (int32 weights, as the
    reference's int32 engine)."""
    return [(torch.as_tensor(a, dtype=torch.long, device=device),
             torch.as_tensor(b, dtype=torch.long, device=device),
             torch.as_tensor(wa.astype(np.int32), device=device),
             torch.as_tensor(wb.astype(np.int32), device=device),
             torch.as_tensor(is_mul, device=device),
             torch.as_tensor(is_add, device=device))
            for a, b, wa, wb, is_mul, is_add in compiled_stages(key, cos_bit)]


# spec sin_pi table (ref av1_sinpi_arr_data, EbTransforms.c:1301-1308)
_SINPI = {10 + i: np.array(row, np.int64) for i, row in enumerate((
    (0, 330, 621, 836, 951), (0, 660, 1241, 1672, 1901),
    (0, 1321, 2482, 3344, 3803), (0, 2642, 4964, 6689, 7606),
    (0, 5283, 9929, 13377, 15212), (0, 10566, 19858, 26755, 30424),
    (0, 21133, 39716, 53510, 60849)))}


def sinpi_arr(bit: int) -> np.ndarray:
    return _SINPI[bit]


# --- int32 1-D engine ---------------------------------------------------------

def _run_stages(x, key: str, cos_bit: int, clamp_bit: int):
    for a, b, wa, wb, is_mul, is_add in _stages_on(key, cos_bit, x.device):
        y = wa * x[..., a] + wb * x[..., b]
        y = torch.where(is_mul, round_shift(y, cos_bit), y)
        if clamp_bit > 0:
            y = torch.where(is_add, _clamp(y, clamp_bit), y)
        x = y
    return x


def _iadst4(x, cos_bit: int):
    sp = [int(v) for v in sinpi_arr(cos_bit)]
    x0, x1, x2, x3 = (x[..., i] for i in range(4))
    s0 = sp[1] * x0
    s1 = sp[2] * x0
    s2 = sp[3] * x1
    s3 = sp[4] * x2
    s4 = sp[1] * x2
    s5 = sp[2] * x3
    s6 = sp[4] * x3
    s7 = (x0 - x2) + x3
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = sp[3] * s7
    s0 = s0 + s5
    s1 = s1 - s6
    o = torch.stack([s0 + s3, s1 + s3, s2, (s0 + s1) - s3], dim=-1)
    return round_shift(o, cos_bit)


def _fadst4(x, cos_bit: int):
    sp = [int(v) for v in sinpi_arr(cos_bit)]
    x0, x1, x2, x3 = (x[..., i] for i in range(4))
    s0 = sp[1] * x0
    s1 = sp[4] * x0
    s2 = sp[2] * x1
    s3 = sp[1] * x1
    s4 = sp[3] * x2
    s5 = sp[4] * x3
    s6 = sp[2] * x3
    s7 = x0 + x1 - x3
    y0 = s0 + s2 + s5
    y1 = sp[3] * s7
    y2 = s1 - s3 + s6
    y3 = s4
    o = torch.stack([y0 + y3, y1, y2 - y3, (y2 - y0) + y3], dim=-1)
    return round_shift(o, cos_bit)


def _identity(x, n: int):
    mult, shift = _IDENTITY_MULT[n]
    y = x * mult
    return round_shift(y, NEW_SQRT2_BITS) if shift else y


def _inv_txfm1d(x, kind: int, n: int, cos_bit: int, clamp_bit: int):
    if kind == _I:
        return _identity(x, n)
    if kind in (_A, _F) and n == 4:
        return _iadst4(x, cos_bit)
    base = "dct" if kind == _D else "adst"
    return _run_stages(x, f"i{base}{n}", cos_bit, clamp_bit)


def _fwd_txfm1d(x, kind: int, n: int, cos_bit: int):
    if kind == _I:
        return _identity(x, n)
    if kind in (_A, _F) and n == 4:
        return _fadst4(x, cos_bit)
    base = "dct" if kind == _D else "adst"
    return _run_stages(x, f"f{base}{n}", cos_bit, 0)


def inv_txfm2d_batch(coeffs, tx_size: int, tx_type: int, bd: int = 8):
    """Normative inverse transform, batched: [..., H, W] -> int32 [..., H, W].

    int32 is exact here: the spec's per-stage clamps bound every
    intermediate product below 2^31 (as in the reference package)."""
    w, h = TX_W[tx_size], TX_H[tx_size]
    s0, s1 = INV_SHIFT[tx_size]
    wi, hi = w.bit_length() - 3, h.bit_length() - 3
    vk, hk = _VH[tx_type]
    ud, lr = flip_cfg(tx_type)
    range_row = 16 if bd == 8 else 18

    x = coeffs.to(torch.int32)
    if abs(wi - hi) == 1:
        x = round_shift(x * NEW_INV_SQRT2, NEW_SQRT2_BITS)
    x = _clamp(x, bd + 8)
    rows = _inv_txfm1d(x, hk, w, INV_COS_BIT, range_row)     # over last axis W
    rows = _round_shift_array(rows, -s0)
    if lr:
        rows = rows.flip(-1)
    cols = rows.transpose(-1, -2)                            # [..., W, H]
    cols = _clamp(cols, max(bd + 6, 16))
    cols = _inv_txfm1d(cols, vk, h, INV_COS_BIT, 16)
    cols = _round_shift_array(cols, -s1)
    out = cols.transpose(-1, -2)
    if ud:
        out = out.flip(-2)
    return out.contiguous()


def fwd_txfm2d_batch_exact(resid, tx_size: int, tx_type: int, bd: int = 8):
    """Bit-exact integer forward transform in int32, batched [..., H, W]
    (int32 suffices: the forward cos-bits bound every product below 2^31
    for 8-bit residuals, as in the reference package)."""
    w, h = TX_W[tx_size], TX_H[tx_size]
    s0, s1, s2 = FWD_SHIFT[tx_size]
    wi, hi = w.bit_length() - 3, h.bit_length() - 3
    cb_col, cb_row = FWD_COS_BIT_COL[wi][hi], FWD_COS_BIT_ROW[wi][hi]
    vk, hk = _VH[tx_type]
    ud, lr = flip_cfg(tx_type)

    x = resid.to(torch.int32)
    if ud:
        x = x.flip(-2)
    cols = x.transpose(-1, -2)                       # [..., W, H]
    cols = _round_shift_array(cols, -s0)
    cols = _fwd_txfm1d(cols, vk, h, cb_col)
    cols = _round_shift_array(cols, -s1)
    buf = cols.transpose(-1, -2)                     # [..., H, W]
    if lr:
        buf = buf.flip(-1)
    rows = _fwd_txfm1d(buf, hk, w, cb_row)
    rows = _round_shift_array(rows, -s2)
    if abs(wi - hi) == 1:
        rows = round_shift(rows * NEW_SQRT2, NEW_SQRT2_BITS)
    return rows.contiguous()


# --- f32 matrix forward (inter path; non-normative encoder side) ------------

def _run_stages_float(x: np.ndarray, key: str, cos_bit: int) -> np.ndarray:
    """Stage engine in exact real arithmetic (round_shift -> divide)."""
    for a, b, wa, wb, is_mul, _ in compiled_stages(key, cos_bit):
        y = wa[None, :] * x[:, a] + wb[None, :] * x[:, b]
        x = np.where(is_mul[None, :], y / (1 << cos_bit), y)
    return x


def _fadst4_np(x: np.ndarray, cos_bit: int) -> np.ndarray:
    """Spec-mirror forward ADST-4 on [B, 4] int64 (matrix probe only)."""
    return _fadst4(torch.from_numpy(x), cos_bit).numpy()


def _txfm1d_matrix(kind: int, n: int, cos_bit: int) -> np.ndarray:
    """N x N real matrix of one forward 1-D transform (rounding ablated)."""
    eye = np.eye(n, dtype=np.float64)
    if kind == _I:
        mult, shift = _IDENTITY_MULT[n]
        return eye * (mult / (1 << NEW_SQRT2_BITS) if shift else mult)
    if kind in (_A, _F) and n == 4:
        # probe the exact linear fadst4 on scaled impulses
        out = np.zeros((4, 4))
        for j in range(4):
            x = np.zeros((1, 4), np.int64)
            x[0, j] = 1 << 20
            out[:, j] = _fadst4_np(x, cos_bit)[0] / (1 << 20)
        return out
    base = "dct" if kind == _D else "adst"
    out = _run_stages_float(eye, f"f{base}{n}", cos_bit)
    return out.T  # engine row b = M @ e_b, so M = out^T


@functools.lru_cache(maxsize=None)
def _fwd_matrices(tx_size: int, tx_type: int) -> tuple[np.ndarray, np.ndarray]:
    """(M_col [H,H], M_row [W,W]) f32 with flips/shifts/rect-scale folded in,
    such that coeffs ~= M_col @ resid @ M_row^T."""
    w, h = TX_W[tx_size], TX_H[tx_size]
    s0, s1, s2 = FWD_SHIFT[tx_size]
    wi, hi = w.bit_length() - 3, h.bit_length() - 3
    cb_col, cb_row = FWD_COS_BIT_COL[wi][hi], FWD_COS_BIT_ROW[wi][hi]
    vk, hk = _VH[tx_type]
    ud, lr = flip_cfg(tx_type)

    mc = _txfm1d_matrix(vk, h, cb_col)
    mr = _txfm1d_matrix(hk, w, cb_row)
    if ud:
        mc = mc[:, ::-1]
    if lr:
        mr = mr[:, ::-1]
    scale = 2.0 ** (s0 + s1 + s2)
    if abs(wi - hi) == 1:
        scale *= NEW_SQRT2 / (1 << NEW_SQRT2_BITS)
    mc = mc * scale  # fold full scale into one factor
    return (np.ascontiguousarray(mc, np.float32),
            np.ascontiguousarray(mr, np.float32))


@functools.lru_cache(maxsize=None)
def _fwd_matrices_on(tx_size: int, tx_type: int, device: torch.device):
    mc, mr = _fwd_matrices(tx_size, tx_type)
    return (torch.as_tensor(mc, device=device),
            torch.as_tensor(mr, device=device))


def fwd_txfm2d_batch(resid, tx_size: int, tx_type: int, bd: int = 8):
    """Forward transform, batched [..., H, W] -> [..., H, W] int32 coeffs.

    coeffs = round(M_col @ resid @ M_row^T) in f32, summed over the inner
    index in ascending order with one rounded multiply and one rounded
    add per term (no matmul, no FMA), so every device gives the same
    bits.  Non-normative: the levels it feeds are self-consistent with
    the exact inverse, so recon parity never depends on it."""
    mc, mr = _fwd_matrices_on(tx_size, tx_type, resid.device)
    x = resid.to(torch.float32)
    h, w = x.shape[-2], x.shape[-1]
    # column pass: t[..., i, k] = sum_j mc[i, j] * x[..., j, k]
    t = mc[:, 0, None] * x[..., 0:1, :]
    for j in range(1, h):
        t = t + mc[:, j, None] * x[..., j:j + 1, :]
    # row pass: y[..., i, l] = sum_k t[..., i, k] * mr[l, k]
    y = t[..., 0:1] * mr[:, 0]
    for k in range(1, w):
        y = y + t[..., k:k + 1] * mr[:, k]
    return torch.round(y).to(torch.int32)
