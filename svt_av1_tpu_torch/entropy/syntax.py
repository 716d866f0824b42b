"""AV1 symbol layer: partition / mode-info / coefficient syntax + contexts.

ONE module implements both the encoder and the mirror decoder for every
syntax element, with paired ``write_*`` / ``read_*`` methods sharing all
context derivation — symmetry by construction.

Reference parity (behavioral): EbEntropyCoding.c write_sb stack —
EncodePartitionAv1 (:934), EncodeSkipCoeffAv1 (:1016), intra mode writers
(:1080+), Av1WriteCoeffsTxb1D (:496) with GetTxbCtx (:327), GetBrCtx
(:285), nz-map contexts (encodetxb_sse2.c:470), golomb (:187),
eob tokens (:203-236).  Context model state mirrors EbNeighborArrays.c.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from svt_av1_tpu_torch.tables import default_scan
from svt_av1_tpu_torch.entropy.cdf_model import FrameContext, update_icdf
from svt_av1_tpu_torch.ops.transforms import TX_H, TX_W

# --- intra modes (AV1 enum order) -------------------------------------------
DC_PRED, V_PRED, H_PRED = 0, 1, 2
D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED = 3, 4, 5, 6, 7, 8
SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED = 9, 10, 11, 12
INTRA_MODES = 13
UV_CFL_PRED = 13
MAX_ANGLE_DELTA = 3

# spec Intra_Mode_Context (ref EbDefinitions.h:1213)
INTRA_MODE_CONTEXT = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]

# --- partitions ---------------------------------------------------------------
PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT = 0, 1, 2, 3
PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B = 4, 5, 6, 7
PARTITION_HORZ_4, PARTITION_VERT_4 = 8, 9

# --- block sizes (AV1 enum order, (w4, h4) in 4x4 units) ----------------------
BLOCK_DIMS = [
    (1, 1), (1, 2), (2, 1), (2, 2), (2, 4), (4, 2), (4, 4), (4, 8), (8, 4),
    (8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16), (32, 32),
    (1, 4), (4, 1), (2, 8), (8, 2), (4, 16), (16, 4),
]
BLOCK_4X4, BLOCK_8X8, BLOCK_16X16, BLOCK_32X32, BLOCK_64X64 = 0, 3, 6, 9, 12
BLOCK_128X128 = 15


def block_size_of(w4: int, h4: int) -> int:
    return BLOCK_DIMS.index((w4, h4))


# --- tx classes ---------------------------------------------------------------
TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2


def tx_class_of(tx_type: int) -> int:
    if tx_type in (10, 12, 14):   # V_DCT, V_ADST, V_FLIPADST
        return TX_CLASS_VERT
    if tx_type in (11, 13, 15):   # H_DCT, H_ADST, H_FLIPADST
        return TX_CLASS_HORIZ
    return TX_CLASS_2D


# tx size helper tables (spec)
def _sqr_idx(n: int) -> int:
    return {4: 0, 8: 1, 16: 2, 32: 3, 64: 4}[n]


def txsize_sqr(tx_size: int) -> int:
    return _sqr_idx(min(TX_W[tx_size], TX_H[tx_size]))


def txsize_sqr_up(tx_size: int) -> int:
    return _sqr_idx(max(TX_W[tx_size], TX_H[tx_size]))


def tx_size_ctx(tx_size: int) -> int:
    """txs_ctx = (sqr + sqr_up + 1) >> 1 (ref Av1WriteCoeffsTxb1D)."""
    return (txsize_sqr(tx_size) + txsize_sqr_up(tx_size) + 1) >> 1


def adjusted_dims(tx_size: int) -> tuple[int, int]:
    """Coded coefficient area (spec Adjusted_Tx_Size: dim-64 -> 32)."""
    return min(TX_W[tx_size], 32), min(TX_H[tx_size], 32)


# --- ext-tx sets (spec; ref EbDefinitions.h:1460-1510) ------------------------
EXT_TX_SET_DCTONLY, EXT_TX_SET_DCT_IDTX, EXT_TX_SET_DTT4_IDTX = 0, 1, 2
EXT_TX_SET_DTT4_IDTX_1DDCT, EXT_TX_SET_DTT9_IDTX_1DDCT, EXT_TX_SET_ALL16 = 3, 4, 5
NUM_EXT_TX_SET = [1, 2, 5, 7, 12, 16]
# symbol index of each tx type within each set (spec inverse mapping)
EXT_TX_IND = [
    [0] * 16,
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 3, 4, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 5, 6, 4, 0, 0, 0, 0, 0, 0, 2, 3, 0, 0, 0, 0],
    [3, 4, 5, 8, 6, 7, 9, 10, 11, 0, 1, 2, 0, 0, 0, 0],
    [7, 8, 9, 12, 10, 11, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6],
]
# inverse: symbol -> tx type (spec av1_ext_tx_inv)
EXT_TX_INV = [
    [0] * 16,
    [9, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 0, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 0, 10, 11, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 10, 11, 0, 1, 2, 4, 5, 3, 6, 7, 8, 0, 0, 0, 0],
    [9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 4, 5, 3, 6, 7, 8],
]
EXT_TX_SET_TO_INTRA_ESET = {EXT_TX_SET_DTT4_IDTX_1DDCT: 1, EXT_TX_SET_DTT4_IDTX: 2}


def scan_for(w: int, h: int, tx_class: int) -> np.ndarray:
    """Scan order per tx class (ref av1_scan_orders: 2D/IDTX -> default
    zig-zag, V_* -> mrow/raster, H_* -> mcol/column-major)."""
    if tx_class == TX_CLASS_2D:
        return default_scan(h, w)
    if tx_class == TX_CLASS_VERT:
        return np.arange(w * h, dtype=np.int32)
    return np.ascontiguousarray(
        np.arange(w * h, dtype=np.int32).reshape(h, w).T.ravel())


def intra_tx_set_type(tx_size: int, reduced_tx_set: bool) -> int:
    squp = txsize_sqr_up(tx_size)
    if squp > 3:
        return EXT_TX_SET_DCTONLY
    if squp == 3:
        return EXT_TX_SET_DCTONLY
    if reduced_tx_set:
        return EXT_TX_SET_DTT4_IDTX
    return (EXT_TX_SET_DTT4_IDTX if txsize_sqr(tx_size) == 2
            else EXT_TX_SET_DTT4_IDTX_1DDCT)


# --- eob grouping (ref EbEntropyCoding.c:187-236) -----------------------------
EOB_GROUP_START = [0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513]
EOB_OFFSET_BITS = [0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9]


def eob_pos_token(eob: int) -> tuple[int, int]:
    """(eobPt, extra): group token and offset within the group."""
    assert eob >= 1
    if eob < 3:
        t = eob
    else:
        t = (eob - 1).bit_length() + 1  # eob in (2^(t-2), 2^(t-1)]
    return t, eob - EOB_GROUP_START[t]


# --- nz-map context offsets (spec rule; ref av1_nz_map_ctx_offset data) -------
def nz_map_ctx_offset(w: int, h: int) -> np.ndarray:
    """[h, w] int8 2-D-class base-context offsets for (adjusted) dims."""
    r = np.arange(h)[:, None]
    c = np.arange(w)[None, :]
    if w < h:        # tall
        off = np.where(r < 2, 11, np.where(r + c < 4, 6, 21))
    elif w > h:      # wide
        off = np.where(c < 2, 16, np.where(r + c < 4, 6, 21))
    else:
        off = np.where(r + c < 2, 1, np.where(r + c < 4, 6, 21))
    off[0, 0] = 0
    return off.astype(np.int8)


TX_PAD_HOR = 4
TX_PAD_TOP, TX_PAD_BOTTOM = 2, 4


def padded_levels(levels2d: np.ndarray) -> np.ndarray:
    """uint8 |level| buffer with the spec's padding halo for ctx gathers."""
    h, w = levels2d.shape
    buf = np.zeros((h + TX_PAD_TOP + TX_PAD_BOTTOM, w + TX_PAD_HOR), np.uint8)
    buf[TX_PAD_TOP : TX_PAD_TOP + h, :w] = np.minimum(np.abs(levels2d), 127)
    return buf


def _nz_neighbors(lv: np.ndarray, tx_class: int):
    """5 base-ctx neighbor planes from the padded buffer (top pad removed)."""
    h = lv.shape[0] - TX_PAD_TOP - TX_PAD_BOTTOM
    w = lv.shape[1] - TX_PAD_HOR
    p = lv[TX_PAD_TOP:, :]

    def at(dr, dc):
        return p[dr : dr + h, dc : dc + w]

    if tx_class == TX_CLASS_2D:
        offs = [(0, 1), (1, 0), (0, 2), (1, 1), (2, 0)]
    elif tx_class == TX_CLASS_HORIZ:
        offs = [(0, 1), (1, 0), (0, 2), (0, 3), (0, 4)]
    else:
        offs = [(0, 1), (1, 0), (2, 0), (3, 0), (4, 0)]
    return [at(*o) for o in offs]


def base_ctx_grid(lv_padded: np.ndarray, tx_class: int) -> np.ndarray:
    """coeff_base contexts for every position ([h, w]); eob position is
    overridden by the caller (ref av1_get_nz_map_contexts)."""
    h = lv_padded.shape[0] - TX_PAD_TOP - TX_PAD_BOTTOM
    w = lv_padded.shape[1] - TX_PAD_HOR
    nbr = _nz_neighbors(lv_padded, tx_class)
    mag = sum(np.minimum(n.astype(np.int32), 3) for n in nbr)
    count = np.minimum((mag + 1) >> 1, 4)
    if tx_class == TX_CLASS_2D:
        return (count + nz_map_ctx_offset(w, h)).astype(np.int32)
    r = np.arange(h)[:, None]
    c = np.arange(w)[None, :]
    band = np.minimum(c if tx_class == TX_CLASS_HORIZ else r, 2)
    return (count + 26 + 5 * band).astype(np.int32)


def br_ctx_grid(lv_padded: np.ndarray, tx_class: int) -> np.ndarray:
    """coeff_br contexts for every position (ref GetBrCtx)."""
    h = lv_padded.shape[0] - TX_PAD_TOP - TX_PAD_BOTTOM
    w = lv_padded.shape[1] - TX_PAD_HOR
    p = lv_padded[TX_PAD_TOP:, :]

    def at(dr, dc):
        return p[dr : dr + h, dc : dc + w].astype(np.int32)

    mag = at(0, 1) + at(1, 0)
    if tx_class == TX_CLASS_2D:
        mag += at(1, 1)
    elif tx_class == TX_CLASS_HORIZ:
        mag += at(0, 2)
    else:
        mag += at(2, 0)
    mag = np.minimum((mag + 1) >> 1, 6)
    r = np.arange(h)[:, None]
    c = np.arange(w)[None, :]
    if tx_class == TX_CLASS_2D:
        near = (r < 2) & (c < 2)
    elif tx_class == TX_CLASS_HORIZ:
        near = c == 0
    else:
        near = r == 0
    ctx = mag + np.where(near, 7, 14)
    ctx[0, 0] = mag[0, 0]
    return ctx


def eob_base_ctx(c: int, area: int) -> int:
    """coeff_base_eob context for scan index c (ref encodetxb_sse2.c:549)."""
    if c == 0:
        return 0
    if c <= area // 8:
        return 1
    if c <= area // 4:
        return 2
    return 3


def _br_ctx_at(lv_padded: np.ndarray, row: int, col: int, tx_class: int) -> int:
    """Single-position br ctx (decoder side, partial levels)."""
    p = lv_padded[TX_PAD_TOP:, :]
    mag = int(p[row, col + 1]) + int(p[row + 1, col])
    if tx_class == TX_CLASS_2D:
        mag += int(p[row + 1, col + 1])
        near = row < 2 and col < 2
    elif tx_class == TX_CLASS_HORIZ:
        mag += int(p[row, col + 2])
        near = col == 0
    else:
        mag += int(p[row + 2, col])
        near = row == 0
    mag = min((mag + 1) >> 1, 6)
    if row == 0 and col == 0:
        return mag
    return mag + (7 if near else 14)


def _base_ctx_at(lv_padded: np.ndarray, row: int, col: int, w: int, h: int,
                 tx_class: int) -> int:
    p = lv_padded[TX_PAD_TOP:, :]
    if tx_class == TX_CLASS_2D:
        offs = [(0, 1), (1, 0), (0, 2), (1, 1), (2, 0)]
    elif tx_class == TX_CLASS_HORIZ:
        offs = [(0, 1), (1, 0), (0, 2), (0, 3), (0, 4)]
    else:
        offs = [(0, 1), (1, 0), (2, 0), (3, 0), (4, 0)]
    mag = sum(min(int(p[row + dr, col + dc]), 3) for dr, dc in offs)
    count = min((mag + 1) >> 1, 4)
    if tx_class == TX_CLASS_2D:
        if row == 0 and col == 0:
            return count
        if w < h:
            off = 11 if row < 2 else (6 if row + col < 4 else 21)
        elif w > h:
            off = 16 if col < 2 else (6 if row + col < 4 else 21)
        else:
            off = 1 if row + col < 2 else (6 if row + col < 4 else 21)
        return count + off
    band = min(col if tx_class == TX_CLASS_HORIZ else row, 2)
    return count + 26 + 5 * band


# =============================================================================
# Tile context model (neighbor state; ref EbNeighborArrays.c usage)
# =============================================================================

@dataclass
class TileContexts:
    mi_rows: int
    mi_cols: int
    # per-4x4 grids (luma/mi coordinates)
    mi_sizes: np.ndarray = field(init=False)   # block size enum per 4x4
    y_modes: np.ndarray = field(init=False)
    skips: np.ndarray = field(init=False)
    avail_u: np.ndarray = field(init=False)    # derived per access
    part_above: np.ndarray = field(init=False)  # 32 - w4 of coded block
    part_left: np.ndarray = field(init=False)
    # per-plane coefficient contexts: culLevel | dcCat<<6 per plane-4x4 unit
    lvl_above: list = field(init=False)
    lvl_left: list = field(init=False)

    def __post_init__(self):
        mr, mc = self.mi_rows, self.mi_cols
        self.mi_sizes = np.full((mr, mc), -1, np.int8)
        self.y_modes = np.zeros((mr, mc), np.int8)  # DC default for ctx
        self.skips = np.zeros((mr, mc), np.int8)
        self.part_above = np.zeros(mc, np.uint8)
        self.part_left = np.zeros(mr, np.uint8)
        cr, cc = (mr + 1) >> 1, (mc + 1) >> 1
        self.lvl_above = [np.zeros(mc, np.uint8), np.zeros(cc, np.uint8),
                          np.zeros(cc, np.uint8)]
        self.lvl_left = [np.zeros(mr, np.uint8), np.zeros(cr, np.uint8),
                         np.zeros(cr, np.uint8)]

    # -- partition ctx (ref EncodePartitionAv1) --------------------------------
    def partition_ctx(self, r: int, c: int, bsl: int) -> int:
        above = (int(self.part_above[c]) >> bsl) & 1
        left = (int(self.part_left[r]) >> bsl) & 1
        return (left * 2 + above) + bsl * 4

    def update_partition(self, r: int, c: int, w4: int, h4: int) -> None:
        self.part_above[c : c + w4] = 32 - w4
        self.part_left[r : r + h4] = 32 - h4

    # -- skip ctx ---------------------------------------------------------------
    def skip_ctx(self, r: int, c: int) -> int:
        above = int(self.skips[r - 1, c]) if r > 0 else 0
        left = int(self.skips[r, c - 1]) if c > 0 else 0
        return above + left

    # -- kf y mode ctx ----------------------------------------------------------
    def kf_y_ctx(self, r: int, c: int) -> tuple[int, int]:
        above = int(self.y_modes[r - 1, c]) if r > 0 else DC_PRED
        left = int(self.y_modes[r, c - 1]) if c > 0 else DC_PRED
        return INTRA_MODE_CONTEXT[above], INTRA_MODE_CONTEXT[left]

    def set_block(self, r: int, c: int, w4: int, h4: int, bsize: int,
                  y_mode: int, skip: int) -> None:
        self.mi_sizes[r : r + h4, c : c + w4] = bsize
        self.y_modes[r : r + h4, c : c + w4] = y_mode
        self.skips[r : r + h4, c : c + w4] = skip
        self.update_partition(r, c, w4, h4)

    # -- coefficient contexts (ref GetTxbCtx) -----------------------------------
    _SKIP_CTX_TABLE = np.array(
        [[1, 2, 2, 2, 3], [1, 4, 4, 4, 5], [1, 4, 4, 4, 5],
         [1, 4, 4, 4, 5], [1, 4, 4, 4, 6]], np.int32)

    def txb_ctx(self, plane: int, pr: int, pc: int, w4: int, h4: int,
                full_block_tx: bool, larger_block: bool) -> tuple[int, int]:
        """(txb_skip_ctx, dc_sign_ctx) at plane-4x4 position (pr, pc)."""
        above = self.lvl_above[plane][pc : pc + w4].astype(np.int32)
        left = self.lvl_left[plane][pr : pr + h4].astype(np.int32)
        have_above = pr > 0
        have_left = pc > 0
        # dc sign: categories in bits 6+: 1 = negative, 2 = positive
        signs = np.array([0, -1, 1])
        dc_sign = 0
        if have_above:
            dc_sign += int(signs[above >> 6].sum())
        if have_left:
            dc_sign += int(signs[left >> 6].sum())
        dc_ctx = 2 if dc_sign > 0 else (1 if dc_sign < 0 else 0)

        if plane == 0:
            if full_block_tx:
                return 0, dc_ctx
            top = int(np.bitwise_or.reduce(above)) & 63 if have_above else 0
            lft = int(np.bitwise_or.reduce(left)) & 63 if have_left else 0
            mx = min(top | lft, 4)
            mn = min(min(top, lft), 4)
            return int(self._SKIP_CTX_TABLE[mn, mx]), dc_ctx
        top_nz = int((above != 0).sum()) if have_above else 0
        left_nz = int((left != 0).sum()) if have_left else 0
        base = (top_nz != 0) + (left_nz != 0)
        return base + (10 if larger_block else 7), dc_ctx

    def set_txb(self, plane: int, pr: int, pc: int, w4: int, h4: int,
                cul_level: int) -> None:
        self.lvl_above[plane][pc : pc + w4] = cul_level
        self.lvl_left[plane][pr : pr + h4] = cul_level


def cul_level_of(levels2d: np.ndarray) -> int:
    """min(63, sum|level|) | dcSignCategory << 6 (ref set_dc_sign)."""
    cul = int(min(63, np.abs(levels2d.astype(np.int64)).sum()))
    dc = int(levels2d.flat[0])
    if dc < 0:
        cul |= 1 << 6
    elif dc > 0:
        cul += 2 << 6
    return cul


# =============================================================================
# Coefficient codec (paired write/read; ref Av1WriteCoeffsTxb1D)
# =============================================================================

def write_coeffs_txb(enc, fc: FrameContext, levels2d: np.ndarray, tx_size: int,
                     plane_type: int, tx_type: int, txb_skip_ctx: int,
                     dc_sign_ctx: int, *, write_tx_type: bool = False,
                     y_mode: int = 0, reduced_tx_set: bool = True,
                     allow_tx_type: bool = True, is_inter: bool = False) -> int:
    """Write one transform block's coefficients; returns cul_level word."""
    w, h = adjusted_dims(tx_size)
    txs_ctx = tx_size_ctx(tx_size)
    tx_class = tx_class_of(tx_type)
    scan = scan_for(w, h, tx_class)
    flat = levels2d.reshape(-1)
    nz = np.nonzero(flat[scan])[0]
    eob = int(nz[-1]) + 1 if nz.size else 0

    cdf = fc.txb_skip[txs_ctx][txb_skip_ctx]
    enc.encode_symbol(int(eob == 0), cdf, 2)
    update_icdf(cdf, int(eob == 0), 2)
    if eob == 0:
        return 0

    if write_tx_type and plane_type == 0:
        _code_tx_type(enc, None, fc, tx_size, tx_type, y_mode, reduced_tx_set,
                      allow_tx_type, is_inter)

    # eob position token
    eob_pt, extra = eob_pos_token(eob)
    ms = (w * h).bit_length() - 5  # log2(area) - 4
    nsym = 5 + ms
    cdf = fc.eob_pt[16 << ms][plane_type][0 if tx_class == TX_CLASS_2D else 1]
    enc.encode_symbol(eob_pt - 1, cdf, nsym)
    update_icdf(cdf, eob_pt - 1, nsym)
    nbits = EOB_OFFSET_BITS[eob_pt]
    if nbits > 0:
        bit = (extra >> (nbits - 1)) & 1
        cdf = fc.eob_extra[txs_ctx][plane_type][eob_pt]
        enc.encode_symbol(bit, cdf, 2)
        update_icdf(cdf, bit, 2)
        for i in range(1, nbits):
            enc.encode_bool((extra >> (nbits - 1 - i)) & 1, 16384)

    lv = padded_levels(levels2d)
    base_ctx = base_ctx_grid(lv, tx_class).reshape(-1)
    br_ctx = br_ctx_grid(lv, tx_class).reshape(-1)
    absf = np.abs(flat)

    for c in range(eob - 1, -1, -1):
        pos = int(scan[c])
        level = int(absf[pos])
        if c == eob - 1:
            ctx = eob_base_ctx(c, w * h)
            cdf = fc.coeff_base_eob[txs_ctx][plane_type][ctx]
            s = min(level, 3) - 1
            enc.encode_symbol(s, cdf, 3)
            update_icdf(cdf, s, 3)
        else:
            cdf = fc.coeff_base[txs_ctx][plane_type][int(base_ctx[pos])]
            s = min(level, 3)
            enc.encode_symbol(s, cdf, 4)
            update_icdf(cdf, s, 4)
        if level > 2:
            base_range = level - 3
            ctx = int(br_ctx[pos])
            cdf = fc.coeff_br[min(txs_ctx, 3)][plane_type][ctx]
            for idx in range(0, 12, 3):
                k = min(base_range - idx, 3)
                enc.encode_symbol(k, cdf, 4)
                update_icdf(cdf, k, 4)
                if k < 3:
                    break

    # signs + golomb remainders, forward scan order
    for c in range(eob):
        pos = int(scan[c])
        v = int(flat[pos])
        if v == 0:
            continue
        sign = 1 if v < 0 else 0
        if c == 0:
            cdf = fc.dc_sign[plane_type][dc_sign_ctx]
            enc.encode_symbol(sign, cdf, 2)
            update_icdf(cdf, sign, 2)
        else:
            enc.encode_bool(sign, 16384)
        if abs(v) > 14:
            _write_golomb(enc, abs(v) - 15)

    return cul_level_of(levels2d)


def read_coeffs_txb(dec, fc: FrameContext, tx_size: int, plane_type: int,
                    txb_skip_ctx: int, dc_sign_ctx: int, *,
                    read_tx_type: bool = False, y_mode: int = 0,
                    reduced_tx_set: bool = True, allow_tx_type: bool = True,
                    is_inter: bool = False) -> tuple[np.ndarray, int, int]:
    """Mirror of write_coeffs_txb: returns (levels2d, cul_level, tx_type)."""
    # tx type is DCT_DCT unless signaled
    tx_type = 0
    w, h = adjusted_dims(tx_size)
    txs_ctx = tx_size_ctx(tx_size)

    cdf = fc.txb_skip[txs_ctx][txb_skip_ctx]
    all_zero = dec.decode_symbol(cdf, 2)
    update_icdf(cdf, all_zero, 2)
    if all_zero:
        return np.zeros((h, w), np.int32), 0, tx_type

    if read_tx_type and plane_type == 0:
        tx_type = _code_tx_type(None, dec, fc, tx_size, 0, y_mode,
                                reduced_tx_set, allow_tx_type, is_inter)
    tx_class = tx_class_of(tx_type)
    scan = scan_for(w, h, tx_class)

    ms = (w * h).bit_length() - 5
    nsym = 5 + ms
    cdf = fc.eob_pt[16 << ms][plane_type][0 if tx_class == TX_CLASS_2D else 1]
    eob_pt = dec.decode_symbol(cdf, nsym) + 1
    update_icdf(cdf, eob_pt - 1, nsym)
    eob = EOB_GROUP_START[eob_pt]
    nbits = EOB_OFFSET_BITS[eob_pt]
    if nbits > 0:
        cdf = fc.eob_extra[txs_ctx][plane_type][eob_pt]
        bit = dec.decode_symbol(cdf, 2)
        update_icdf(cdf, bit, 2)
        extra = bit << (nbits - 1)
        for i in range(1, nbits):
            extra |= dec.decode_bool(16384) << (nbits - 1 - i)
        eob += extra

    lv = np.zeros((h + TX_PAD_TOP + TX_PAD_BOTTOM, w + TX_PAD_HOR), np.uint8)
    mags = np.zeros(w * h, np.int32)
    for c in range(eob - 1, -1, -1):
        pos = int(scan[c])
        row, col = pos // w, pos % w
        if c == eob - 1:
            ctx = eob_base_ctx(c, w * h)
            cdf = fc.coeff_base_eob[txs_ctx][plane_type][ctx]
            s = dec.decode_symbol(cdf, 3)
            update_icdf(cdf, s, 3)
            level = s + 1
        else:
            ctx = _base_ctx_at(lv, row, col, w, h, tx_class)
            cdf = fc.coeff_base[txs_ctx][plane_type][ctx]
            s = dec.decode_symbol(cdf, 4)
            update_icdf(cdf, s, 4)
            level = s
        if level > 2:
            ctx = _br_ctx_at(lv, row, col, tx_class)
            cdf = fc.coeff_br[min(txs_ctx, 3)][plane_type][ctx]
            for _ in range(0, 12, 3):
                k = dec.decode_symbol(cdf, 4)
                update_icdf(cdf, k, 4)
                level += k
                if k < 3:
                    break
        mags[pos] = level
        lv[TX_PAD_TOP + row, col] = min(level, 127)

    out = np.zeros(w * h, np.int32)
    for c in range(eob):
        pos = int(scan[c])
        level = int(mags[pos])
        if level == 0:
            continue
        if c == 0:
            cdf = fc.dc_sign[plane_type][dc_sign_ctx]
            sign = dec.decode_symbol(cdf, 2)
            update_icdf(cdf, sign, 2)
        else:
            sign = dec.decode_bool(16384)
        if level > 14:
            level = 15 + _read_golomb(dec)
        out[pos] = -level if sign else level

    out2d = out.reshape(h, w)
    return out2d, cul_level_of(out2d), tx_type


def _code_tx_type(enc, dec, fc: FrameContext, tx_size: int, tx_type: int,
                  y_mode: int, reduced_tx_set: bool, allow: bool,
                  is_inter: bool = False) -> int:
    """Paired tx-type write/read (ref Av1WriteTxType)."""
    if is_inter:
        set_type = inter_tx_set_type(tx_size, reduced_tx_set)
    else:
        set_type = intra_tx_set_type(tx_size, reduced_tx_set)
    if NUM_EXT_TX_SET[set_type] <= 1 or not allow:
        return 0
    sq = txsize_sqr(tx_size)
    nsym = NUM_EXT_TX_SET[set_type]
    if is_inter:
        # ext_tx_set_index[inter] (ref EbDefinitions.h:1507-1512)
        eset = {EXT_TX_SET_ALL16: 1, EXT_TX_SET_DTT9_IDTX_1DDCT: 2,
                EXT_TX_SET_DCT_IDTX: 3}[set_type]
        cdf = fc.inter_ext_tx[eset][sq]
    else:
        eset = EXT_TX_SET_TO_INTRA_ESET[set_type]
        cdf = fc.intra_ext_tx[eset][sq][y_mode]
    if enc is not None:
        s = EXT_TX_IND[set_type][tx_type]
        enc.encode_symbol(s, cdf, nsym)
        update_icdf(cdf, s, nsym)
        return tx_type
    s = dec.decode_symbol(cdf, nsym)
    update_icdf(cdf, s, nsym)
    return EXT_TX_INV[set_type][s]


def inter_tx_set_type(tx_size: int, reduced_tx_set: bool) -> int:
    """ref get_ext_tx_set_type, inter branch (EbDefinitions.h:1481)."""
    squp = txsize_sqr_up(tx_size)
    if squp > 3:
        return EXT_TX_SET_DCTONLY
    if squp == 3 or reduced_tx_set:
        return EXT_TX_SET_DCT_IDTX
    return (EXT_TX_SET_DTT9_IDTX_1DDCT if txsize_sqr(tx_size) == 2
            else EXT_TX_SET_ALL16)


def _write_golomb(enc, level: int) -> None:
    x = level + 1
    length = x.bit_length()
    for _ in range(length - 1):
        enc.encode_bool(0, 16384)
    for i in range(length - 1, -1, -1):
        enc.encode_bool((x >> i) & 1, 16384)


def _read_golomb(dec) -> int:
    length = 0
    while dec.decode_bool(16384) == 0:
        length += 1
        if length > 31:
            raise ValueError("bad golomb code")
    x = 1
    for _ in range(length):
        x = (x << 1) | dec.decode_bool(16384)
    return x - 1


# =============================================================================
# Inter block syntax (paired write/read; ref EbEntropyCoding.c inter path:
# EncodePredModeAv1 :1231, WriteRefFrames :2420, WriteInterMode :1610,
# WriteDrlIdx :1641, av1_encode_mv :1747, Av1CollectNeighborsRefCounts :2154)
# =============================================================================

from svt_av1_tpu_torch.entropy import mvp as _mvp  # noqa: E402 (cycle-free)

NEARESTMV, NEARMV, GLOBALMV, NEWMV = (
    _mvp.NEARESTMV, _mvp.NEARMV, _mvp.GLOBALMV, _mvp.NEWMV)

MV_CLASSES = 11
CLASS0_BITS = 1
CLASS0_SIZE = 1 << CLASS0_BITS


def code_delta_q(enc, dec, fc, delta=None) -> int:
    """Per-superblock delta_q (spec read_delta_qindex, 5.11.41; ref
    av1_write_delta_qindex).  ``delta`` is the RES-SCALED value
    ("reduced": applied as delta << delta_q_res).  Coded at the first
    block of each superblock when the frame header sets
    delta_q_present.  Paired write/read; returns the scaled delta."""
    DELTA_Q_SMALL = 3
    if enc is not None:
        a = abs(int(delta))
        sym = min(a, DELTA_Q_SMALL)
        _code_sym(enc, None, fc.delta_q, 4, sym)
        if sym == DELTA_Q_SMALL:
            n = (a - 1).bit_length() - 1        # a in [2^n+1, 2^(n+1)]
            for i in range(2, -1, -1):          # rem_bits = n - 1, L(3)
                enc.encode_bool(((n - 1) >> i) & 1, 16384)
            bits = a - 1 - (1 << n)
            for i in range(n - 1, -1, -1):      # abs_bits, L(n)
                enc.encode_bool((bits >> i) & 1, 16384)
        if a:
            enc.encode_bool(1 if delta < 0 else 0, 16384)
        return int(delta)
    a = _code_sym(None, dec, fc.delta_q, 4)
    if a == DELTA_Q_SMALL:
        n = 0
        for _ in range(3):
            n = (n << 1) | dec.decode_bool(16384)
        n += 1
        bits = 0
        for _ in range(n):
            bits = (bits << 1) | dec.decode_bool(16384)
        a = bits + (1 << n) + 1
    if a and dec.decode_bool(16384):
        a = -a
    return a


def _code_bin(enc, dec, cdf, val=None) -> int:
    if enc is not None:
        enc.encode_symbol(int(val), cdf, 2)
        update_icdf(cdf, int(val), 2)
        return int(val)
    v = dec.decode_symbol(cdf, 2)
    update_icdf(cdf, v, 2)
    return v


def code_cfl_alphas(enc, dec, fc, au=None, av=None):
    """CFL alpha joint-sign + magnitudes (spec read_cfl_alphas; ref
    write_cfl_alphas EbEntropyCoding.c:1140, macros EbDefinitions.h:
    797-832).  alphaQ3 in [-16..16]; (0, 0) is not codable.  Returns
    the (alpha_u, alpha_v) pair on decode."""
    if enc is not None:
        su_ = 0 if au == 0 else (2 if au > 0 else 1)
        sv_ = 0 if av == 0 else (2 if av > 0 else 1)
        joint = su_ * 3 + sv_ - 1
    else:
        joint = None
    joint = _code_sym(enc, dec, fc.cfl_sign, 8, joint)
    su_, sv_ = (joint + 1) // 3, (joint + 1) % 3
    out_u = out_v = 0
    if su_:
        mag = _code_sym(enc, dec, fc.cfl_alpha[joint - 2], 16,
                        None if enc is None else abs(au) - 1)
        out_u = (mag + 1) * (1 if su_ == 2 else -1)
    if sv_:
        mag = _code_sym(enc, dec, fc.cfl_alpha[sv_ * 3 + su_ - 3], 16,
                        None if enc is None else abs(av) - 1)
        out_v = (mag + 1) * (1 if sv_ == 2 else -1)
    return out_u, out_v


def _code_sym(enc, dec, cdf, nsym, val=None) -> int:
    if enc is not None:
        enc.encode_symbol(int(val), cdf, nsym)
        update_icdf(cdf, int(val), nsym)
        return int(val)
    v = dec.decode_symbol(cdf, nsym)
    update_icdf(cdf, v, nsym)
    return v


def code_motion_mode(enc, dec, fc, bsize: int, kind: int, val=None) -> int:
    """Motion-mode symbol (spec read_motion_mode tail; ref
    write_motion_mode, EbEntropyCoding.c:1337).  kind 1: warp not
    derivable here -> 2-symbol obmc cdf (0 SIMPLE / 1 OBMC); kind 2:
    3-symbol motion_mode cdf (0 SIMPLE / 1 OBMC / 2 WARPED).  val is
    the motion-mode enum on encode."""
    if kind == 1:
        return _code_bin(enc, dec, fc.obmc[bsize],
                         None if enc is None else int(val != 0))
    return _code_sym(enc, dec, fc.motion_mode[bsize], 3, val)


def intra_inter_ctx(mi: "_mvp.MiInter", tc: TileContexts, r: int, c: int) -> int:
    """ref EncodePredModeAv1 context (EbEntropyCoding.c:1247-1263)."""
    has_above = r > 0 and tc.mi_sizes[r - 1, c] >= 0
    has_left = c > 0 and tc.mi_sizes[r, c - 1] >= 0
    above_intra = has_above and not mi.is_inter[r - 1, c]
    left_intra = has_left and not mi.is_inter[r, c - 1]
    if has_above and has_left:
        return 3 if (above_intra and left_intra) else int(above_intra or left_intra)
    if has_above:
        return 2 * int(above_intra)
    if has_left:
        return 2 * int(left_intra)
    return 0


def code_is_inter(enc, dec, fc: FrameContext, mi, tc: TileContexts,
                  r: int, c: int, is_inter=None) -> int:
    cdf = fc.intra_inter[intra_inter_ctx(mi, tc, r, c)]
    return _code_bin(enc, dec, cdf, is_inter)


def neighbor_ref_counts(mi: "_mvp.MiInter", tc: TileContexts,
                        r: int, c: int) -> np.ndarray:
    """ref Av1CollectNeighborsRefCounts: top/left mi refs (both refs of
    compound neighbors count)."""
    counts = np.zeros(8, np.int32)
    for nr, nc in ((r - 1, c), (r, c - 1)):
        if nr < 0 or nc < 0 or tc.mi_sizes[nr, nc] < 0 \
                or not mi.is_inter[nr, nc]:
            continue
        counts[int(mi.ref_frame[nr, nc])] += 1
        r2 = int(mi.ref_frame2[nr, nc])
        if r2 > 0:
            counts[r2] += 1
    return counts


def _nbr_state(mi: "_mvp.MiInter", tc: TileContexts, r: int, c: int):
    """(available, is_intra, is_comp, is_backward_single) of one
    neighbor mi."""
    if r < 0 or c < 0 or tc.mi_sizes[r, c] < 0:
        return (False, False, False, False)
    if not mi.is_inter[r, c]:
        return (True, True, False, False)
    comp = int(mi.ref_frame2[r, c]) > 0
    bwd = not comp and int(mi.ref_frame[r, c]) >= 5   # BWDREF..ALTREF
    return (True, False, comp, bwd)


def comp_inter_ctx(mi: "_mvp.MiInter", tc: TileContexts,
                   r: int, c: int) -> int:
    """reference-select (single vs compound) context
    (ref Av1GetReferenceModeContext EbEntropyCoding.c:1972)."""
    aa, ai, ac, ab = _nbr_state(mi, tc, r - 1, c)
    la, li, lc, lb = _nbr_state(mi, tc, r, c - 1)
    if aa and la:
        if not ac and not lc:
            return int(ab) ^ int(lb)
        if not ac:
            return 2 + int(ab or ai)
        if not lc:
            return 2 + int(lb or li)
        return 4
    if la:
        return 3 if lc else int(lb)
    if aa:
        return 3 if ac else int(ab)
    return 1


def code_comp_inter(enc, dec, fc: FrameContext, mi, tc: TileContexts,
                    r: int, c: int, is_comp=None) -> int:
    cdf = fc.comp_inter[comp_inter_ctx(mi, tc, r, c)]
    return _code_bin(enc, dec, cdf, is_comp)


def comp_ref_type_ctx(mi: "_mvp.MiInter", tc: TileContexts,
                      r: int, c: int) -> int:
    """ref Av1GetCompReferenceTypeContext (unidir compounds never
    coded, so has_uni_comp_refs == 0 throughout)."""
    aa, ai, ac, ab = _nbr_state(mi, tc, r - 1, c)
    la, li, lc, lb = _nbr_state(mi, tc, r, c - 1)
    if aa and la:
        if ai and li:
            return 2
        if li:
            return 2 if not ac else 1
        if ai:
            return 2 if not lc else 1
        # inter/inter
        if not ac and not lc:
            return 1 + 2 * int(not (ab ^ lb))
        if not ac or not lc:
            return 1     # single/comp, comp is bidir
        return 0         # comp/comp, both bidir
    if la:
        return 2 if (li or not lc) else 0
    if aa:
        return 2 if (ai or not ac) else 0
    return 2


def code_comp_refs(enc, dec, fc: FrameContext, mi, tc: TileContexts,
                   counts: np.ndarray, r: int, c: int,
                   refs=None):
    """Compound ref pair (BIDIR only): comp_ref_type + comp_ref tree +
    comp_bwdref tree (ref WriteRefFrames compound path).  refs = (fwd
    1..4, bwd 5..7) or None to decode."""
    LA, L2, L3, GD, BW, A2, AL = 1, 2, 3, 4, 5, 6, 7
    tctx = comp_ref_type_ctx(mi, tc, r, c)
    t = _code_bin(enc, dec, fc.comp_ref_type[tctx],
                  None if refs is None else 1)   # BIDIR_COMP_REFERENCE
    assert t == 1, "unidirectional compound not supported"
    # forward side
    p = _ref_ctx(int(counts[LA] + counts[L2]), int(counts[L3] + counts[GD]))
    bit = _code_bin(enc, dec, fc.comp_ref[p][0],
                    None if refs is None else int(refs[0] in (L3, GD)))
    if not bit:
        p1 = _ref_ctx(int(counts[LA]), int(counts[L2]))
        b1 = _code_bin(enc, dec, fc.comp_ref[p1][1],
                       None if refs is None else int(refs[0] == L2))
        fwd = L2 if b1 else LA
    else:
        p2 = _ref_ctx(int(counts[L3]), int(counts[GD]))
        b2 = _code_bin(enc, dec, fc.comp_ref[p2][2],
                       None if refs is None else int(refs[0] == GD))
        fwd = GD if b2 else L3
    # backward side
    pb = _ref_ctx(int(counts[BW] + counts[A2]), int(counts[AL]))
    bb = _code_bin(enc, dec, fc.comp_bwdref[pb][0],
                   None if refs is None else int(refs[1] == AL))
    if bb:
        bwd = AL
    else:
        pb1 = _ref_ctx(int(counts[BW]), int(counts[A2]))
        b3 = _code_bin(enc, dec, fc.comp_bwdref[pb1][1],
                       None if refs is None else int(refs[1] == A2))
        bwd = A2 if b3 else BW
    return (fwd, bwd)


# compound inter modes (AV1 enum; INTER_COMPOUND_OFFSET base)
NEAREST_NEARESTMV, NEAR_NEARMV = 17, 18
NEAREST_NEWMV, NEW_NEARESTMV, NEAR_NEWMV, NEW_NEARMV = 19, 20, 21, 22
GLOBAL_GLOBALMV, NEW_NEWMV = 23, 24

_COMP_MODE_CTX_MAP = ((0, 1, 1, 1, 1), (1, 2, 3, 4, 4), (4, 4, 5, 6, 7))


# ---- raw-bit primitives in the tile data (ref aom_write_bit/literal) ----

def _code_bool_raw(enc, dec, bit=None) -> int:
    if enc is not None:
        enc.encode_bool(int(bit), 16384)
        return int(bit)
    return dec.decode_bool(16384)


def code_literal(enc, dec, n: int, v=None) -> int:
    out = 0
    for b in range(n - 1, -1, -1):
        bit = _code_bool_raw(enc, dec,
                             None if v is None else (v >> b) & 1)
        out = (out << 1) | bit
    return out


def code_primitive_quniform(enc, dec, n: int, v=None) -> int:
    """ref aom_write_primitive_quniform: v in [0, n) quasi-uniformly."""
    if n <= 1:
        return 0
    l = (n - 1).bit_length()
    m = (1 << l) - n
    if v is None:
        first = code_literal(enc, dec, l - 1)
    else:
        first = code_literal(enc, dec, l - 1,
                             v if v < m else m + ((v - m) >> 1))
    if first < m:
        return first
    extra = _code_bool_raw(enc, dec,
                           None if v is None else (v - m) & 1)
    return (first << 1) - m + extra


def code_primitive_subexpfin(enc, dec, n: int, k: int, v=None) -> int:
    """ref aom_write_primitive_subexpfin."""
    i = 0
    mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            return mk + code_primitive_quniform(
                enc, dec, n - mk, None if v is None else v - mk)
        t = _code_bool_raw(enc, dec,
                           None if v is None else int(v >= mk + a))
        if t:
            i += 1
            mk += a
        else:
            return mk + code_literal(enc, dec, b,
                                     None if v is None else v - mk)


def _recenter_nonneg(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    if v >= r:
        return (v - r) << 1
    return ((r - v) << 1) - 1


def _inv_recenter_nonneg(r: int, x: int) -> int:
    if x > (r << 1):
        return x
    if x & 1:
        return r - ((x + 1) >> 1)
    return r + (x >> 1)


def code_primitive_refsubexpfin(enc, dec, n: int, k: int, ref: int,
                                v=None) -> int:
    """ref aom_write_primitive_refsubexpfin (recentered around ref)."""
    if (ref << 1) <= n:
        x = code_primitive_subexpfin(
            enc, dec, n, k,
            None if v is None else _recenter_nonneg(ref, v))
        return _inv_recenter_nonneg(ref, x)
    x = code_primitive_subexpfin(
        enc, dec, n, k,
        None if v is None else _recenter_nonneg(n - 1 - ref, n - 1 - v))
    return n - 1 - _inv_recenter_nonneg(n - 1 - ref, x)


# ---- loop restoration per-RU syntax (ref write_wiener_filter) ----------
WIENER_MIN = (-5, -23, -17)
WIENER_MAX = (10, 8, 46)
WIENER_K = (1, 2, 3)
WIENER_MID = (3, -7, 15)     # default/reset reference taps


def code_wiener_filter(enc, dec, taps_ref, taps=None):
    """Code 6 taps (v0 v1 v2 h0 h1 h2) against the running reference
    filter; returns the coded taps and updates nothing (caller keeps
    the per-plane reference)."""
    out = []
    for half in range(2):                 # vertical then horizontal
        for i in range(3):
            n = WIENER_MAX[i] - WIENER_MIN[i] + 1
            r = taps_ref[half * 3 + i] - WIENER_MIN[i]
            v = None if taps is None else taps[half * 3 + i] - WIENER_MIN[i]
            out.append(code_primitive_refsubexpfin(enc, dec, n,
                                                   WIENER_K[i], r, v)
                       + WIENER_MIN[i])
    return tuple(out)


SGR_PRJ_MIN = (-96, -32)
SGR_PRJ_MAX = (31, 95)
SGR_SUBEXP_K = 4
SGR_XQD_MID = (-32, 31)      # set_default_sgrproj reference


def code_sgr_filter(enc, dec, xqd_ref, ep=None, xqd=None):
    """Per-RU SGRPROJ params: 4-bit ep literal + xqd refsubexp against
    the running reference (ref write_sgrproj_filter,
    EbEntropyCoding.c:4487).  Returns (ep, xqd)."""
    from svt_av1_tpu_torch.ops.restoration import SGR_PARAMS
    ep = code_literal(enc, dec, 4, ep)
    r0, r1 = SGR_PARAMS[ep][0], SGR_PARAMS[ep][1]
    out = list(SGR_XQD_MID)
    if r0 == 0:
        out[0] = 0
        out[1] = code_primitive_refsubexpfin(
            enc, dec, SGR_PRJ_MAX[1] - SGR_PRJ_MIN[1] + 1, SGR_SUBEXP_K,
            xqd_ref[1] - SGR_PRJ_MIN[1],
            None if xqd is None else xqd[1] - SGR_PRJ_MIN[1]) \
            + SGR_PRJ_MIN[1]
    elif r1 == 0:
        out[0] = code_primitive_refsubexpfin(
            enc, dec, SGR_PRJ_MAX[0] - SGR_PRJ_MIN[0] + 1, SGR_SUBEXP_K,
            xqd_ref[0] - SGR_PRJ_MIN[0],
            None if xqd is None else xqd[0] - SGR_PRJ_MIN[0]) \
            + SGR_PRJ_MIN[0]
        out[1] = xqd_ref[1]
    else:
        out[0] = code_primitive_refsubexpfin(
            enc, dec, SGR_PRJ_MAX[0] - SGR_PRJ_MIN[0] + 1, SGR_SUBEXP_K,
            xqd_ref[0] - SGR_PRJ_MIN[0],
            None if xqd is None else xqd[0] - SGR_PRJ_MIN[0]) \
            + SGR_PRJ_MIN[0]
        out[1] = code_primitive_refsubexpfin(
            enc, dec, SGR_PRJ_MAX[1] - SGR_PRJ_MIN[1] + 1, SGR_SUBEXP_K,
            xqd_ref[1] - SGR_PRJ_MIN[1],
            None if xqd is None else xqd[1] - SGR_PRJ_MIN[1]) \
            + SGR_PRJ_MIN[1]
    return ep, tuple(out)


def compound_mode_ctx(res) -> int:
    """ref Av1ModeContextAnalyzer for rf[1] > INTRA_FRAME."""
    return _COMP_MODE_CTX_MAP[res.refmv_ctx >> 1][min(res.newmv_ctx, 4)]


def code_compound_mode(enc, dec, fc: FrameContext, res, mode=None) -> int:
    """inter_compound_mode symbol (ref WriteInterCompoundMode)."""
    cdf = fc.inter_compound_mode[compound_mode_ctx(res)]
    sym = _code_sym(enc, dec, cdf, 8,
                    None if mode is None else mode - NEAREST_NEARESTMV)
    return sym + NEAREST_NEARESTMV


def _ref_ctx(a: int, b: int) -> int:
    return 1 if a == b else (0 if a < b else 2)


def code_single_ref(enc, dec, fc: FrameContext, counts: np.ndarray,
                    ref: int | None = None) -> int:
    """Single-ref tree, LAST..ALTREF (ref WriteRefFrames single path).
    counts = neighbor_ref_counts.  ref frames: 1..7 (LAST..ALTREF)."""
    LA, L2, L3, GD, BW, A2, AL = 1, 2, 3, 4, 5, 6, 7
    fwd = int(counts[LA] + counts[L2] + counts[L3] + counts[GD])
    bwd = int(counts[BW] + counts[A2] + counts[AL])
    p1 = _ref_ctx(fwd, bwd)
    bit0 = _code_bin(enc, dec, fc.single_ref[p1][0],
                     None if ref is None else int(ref >= BW))
    if bit0:
        p2 = _ref_ctx(int(counts[BW] + counts[A2]), int(counts[AL]))
        bit1 = _code_bin(enc, dec, fc.single_ref[p2][1],
                         None if ref is None else int(ref == AL))
        if bit1:
            return AL
        p6 = _ref_ctx(int(counts[BW]), int(counts[A2]))
        bit5 = _code_bin(enc, dec, fc.single_ref[p6][5],
                         None if ref is None else int(ref == A2))
        return A2 if bit5 else BW
    p3 = _ref_ctx(int(counts[LA] + counts[L2]), int(counts[L3] + counts[GD]))
    bit2 = _code_bin(enc, dec, fc.single_ref[p3][2],
                     None if ref is None else int(ref in (L3, GD)))
    if not bit2:
        p4 = _ref_ctx(int(counts[LA]), int(counts[L2]))
        bit3 = _code_bin(enc, dec, fc.single_ref[p4][3],
                         None if ref is None else int(ref != LA))
        return L2 if bit3 else LA
    p5 = _ref_ctx(int(counts[L3]), int(counts[GD]))
    bit4 = _code_bin(enc, dec, fc.single_ref[p5][4],
                     None if ref is None else int(ref != L3))
    return GD if bit4 else L3


def code_inter_mode(enc, dec, fc: FrameContext, res, mode=None) -> int:
    """Single-ref inter mode bins (ref WriteInterMode)."""
    b0 = _code_bin(enc, dec, fc.newmv[res.newmv_ctx],
                   None if mode is None else int(mode != NEWMV))
    if not b0:
        return NEWMV
    b1 = _code_bin(enc, dec, fc.zeromv[res.zeromv_ctx],
                   None if mode is None else int(mode != GLOBALMV))
    if not b1:
        return GLOBALMV
    b2 = _code_bin(enc, dec, fc.refmv[res.refmv_ctx],
                   None if mode is None else int(mode != NEARESTMV))
    return NEARMV if b2 else NEARESTMV


def code_drl_idx(enc, dec, fc: FrameContext, res, mode: int,
                 drl_idx=None) -> int:
    """ref WriteDrlIdx; returns ref_mv_idx."""
    out = 0 if drl_idx is None else drl_idx
    if mode == 24:                        # NEW_NEWMV (ref WriteDrlIdx
        mode = NEWMV                      # new_mv gate)
    elif mode in (18, 21, 22):            # have_nearmv compound modes
        mode = NEARMV
    if mode == NEWMV:
        for idx in range(2):
            if res.num_mv_found > idx + 1:
                bit = _code_bin(enc, dec, fc.drl[res.drl_ctx(idx)],
                                None if drl_idx is None else int(drl_idx != idx))
                if not bit:
                    return idx
                out = idx + 1
        return out
    if mode == NEARMV:
        for idx in range(1, 3):
            if res.num_mv_found > idx + 1:
                bit = _code_bin(
                    enc, dec, fc.drl[res.drl_ctx(idx)],
                    None if drl_idx is None else int(drl_idx != idx - 1))
                if not bit:
                    return idx - 1
                out = idx
        return out
    return 0


def _mv_class_of(z: int) -> int:
    """ref av1_get_mv_class: z = |comp| - 1."""
    if z >= CLASS0_SIZE * 4096:
        return 10
    return max(0, (z >> 3).bit_length() - 1)


def _mv_class_base(c: int) -> int:
    return 0 if c == 0 else CLASS0_SIZE << (c + 2)


def _code_mv_component(enc, dec, fc: FrameContext, comp_idx: int,
                       precision: int, comp=None) -> int:
    """ref encode_mv_component / decoder mirror.  precision: 0 none
    (integer), 1 low (1/4 pel), 2 high (1/8 pel)."""
    if enc is not None:
        sign = int(comp < 0)
        mag = -comp if sign else comp
        z = mag - 1
        mv_class = _mv_class_of(z)
        offset = z - _mv_class_base(mv_class)
        d = offset >> 3
        fr = (offset >> 1) & 3
        hp = offset & 1
    else:
        sign = mv_class = d = fr = hp = None
    sign = _code_bin(enc, dec, fc.nmv_sign[comp_idx], sign)
    mv_class = _code_sym(enc, dec, fc.nmv_classes[comp_idx], MV_CLASSES,
                         mv_class)
    if mv_class == 0:
        d = _code_sym(enc, dec, fc.nmv_class0[comp_idx], CLASS0_SIZE, d)
    else:
        n = mv_class + CLASS0_BITS - 1
        if enc is not None:
            for i in range(n):
                _code_bin(enc, dec, fc.nmv_bits[comp_idx][i], (d >> i) & 1)
        else:
            d = 0
            for i in range(n):
                d |= _code_bin(enc, dec, fc.nmv_bits[comp_idx][i]) << i
    if precision > 0:
        cdf = (fc.nmv_class0_fp[comp_idx][d] if mv_class == 0
               else fc.nmv_fp[comp_idx])
        fr = _code_sym(enc, dec, cdf, 4, fr)
    else:
        fr = 3
    if precision > 1:
        cdf = (fc.nmv_class0_hp[comp_idx] if mv_class == 0
               else fc.nmv_hp[comp_idx])
        hp = _code_bin(enc, dec, cdf, hp)
    else:
        hp = 1
    if enc is not None:
        return comp
    mag = _mv_class_base(mv_class) + (d << 3) + (fr << 1) + hp + 1
    return -mag if sign else mag


def code_mv(enc, dec, fc: FrameContext, ref_mv, mv=None, *,
            allow_hp: bool = False, force_integer: bool = False
            ) -> tuple[int, int]:
    """Paired av1_encode_mv / read_mv.  mv/ref_mv are (row, col) 1/8 pel."""
    precision = 0 if force_integer else (2 if allow_hp else 1)
    if enc is not None:
        diff = (mv[0] - ref_mv[0], mv[1] - ref_mv[1])
        j = (2 if diff[0] else 0) | (1 if diff[1] else 0)
        # joint: 0 zero, 1 h-only, 2 v-only, 3 both (ref av1_get_mv_joint_diff)
        _code_sym(enc, None, fc.nmv_joints, 4, j)
        if j & 2:
            _code_mv_component(enc, None, fc, 0, precision, diff[0])
        if j & 1:
            _code_mv_component(enc, None, fc, 1, precision, diff[1])
        return tuple(mv)
    j = _code_sym(None, dec, fc.nmv_joints, 4)
    dr = _code_mv_component(None, dec, fc, 0, precision) if j & 2 else 0
    dc_ = _code_mv_component(None, dec, fc, 1, precision) if j & 1 else 0
    return (ref_mv[0] + dr, ref_mv[1] + dc_)
