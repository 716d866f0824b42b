// Host entropy backend: daala range coder + AV1 symbol layer in C++.
//
// Exact native twin of the Python reference implementation
// (svt_av1_tpu/entropy/range_coder.py + syntax.py + pipeline/tile.py):
// tests require byte-identical tile output.  The serial range coder is
// the one part of the codec that cannot run on the TPU (SURVEY.md §7
// "hard parts"); the reference runs it in the EntropyCoding pipeline
// stage (EbEntropyCodingProcess.c) — here it is a per-tile C function
// called once per frame, tile-parallel across host threads later.
//
// Build: g++ -O3 -shared -fPIC -o libsvtav1tpu_entropy.so entropy.cpp
// ABI: plain C functions (ctypes); CDF tables are passed as one int32
// blob whose layout is defined by TABLE_DIMS below and mirrored in
// svt_av1_tpu/entropy/backend.py (single source of truth test-pinned).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>

namespace {

// ---------------------------------------------------------------------------
// Range encoder (od_ec semantics; twin of range_coder.RangeEncoder)
// ---------------------------------------------------------------------------
struct RangeEncoder {
  uint32_t low = 0;
  uint32_t rng = 0x8000;
  int cnt = -9;
  std::vector<uint16_t> precarry;

  void normalize(uint32_t l, uint32_t r) {
    int d = 16 - (32 - __builtin_clz(r));  // 16 - bit_length(r)
    int c = cnt;
    int s = c + d;
    if (s >= 0) {
      c += 16;
      uint32_t m = (1u << c) - 1;
      if (s >= 8) {
        precarry.push_back(static_cast<uint16_t>(l >> c));
        l &= m;
        c -= 8;
        m >>= 8;
      }
      precarry.push_back(static_cast<uint16_t>(l >> c));
      s = c + d - 24;
      l &= m;
    }
    low = l << d;
    rng = (r << d) & 0xFFFF;
    cnt = s;
  }

  void encode_symbol(int s, const int32_t* icdf, int nsyms) {
    uint32_t l = low;
    uint32_t r = rng;
    uint32_t fl = s == 0 ? 32768u : static_cast<uint32_t>(icdf[s - 1]);
    uint32_t fh = static_cast<uint32_t>(icdf[s]);
    if (fl < 32768u) {
      uint32_t u = (((r >> 8) * (fl >> 6)) >> 1) + 4u * (nsyms - s);
      uint32_t v = (((r >> 8) * (fh >> 6)) >> 1) + 4u * (nsyms - s - 1);
      l += r - u;
      r = u - v;
    } else {
      r -= (((r >> 8) * (fh >> 6)) >> 1) + 4u * (nsyms - s - 1);
    }
    normalize(l, r);
  }

  void encode_bool(int val, uint32_t f) {
    uint32_t l = low;
    uint32_t r = rng;
    uint32_t v = (((r >> 8) * (f >> 6)) >> 1) + 4u;
    if (val) {
      l += r - v;
      r = v;
    } else {
      r -= v;
    }
    normalize(l, r);
  }

  long done(uint8_t* out, long cap) {
    uint32_t l = low;
    int c = cnt;
    int s = 10 + c;
    uint32_t m = 0x3FFF;
    uint64_t e = ((static_cast<uint64_t>(l) + m) & ~static_cast<uint64_t>(m) &
                  0xFFFFFFFFull) | (m + 1);
    std::vector<uint16_t> pre = precarry;
    if (s > 0) {
      uint64_t n = (1ull << (c + 16)) - 1;
      do {
        pre.push_back(static_cast<uint16_t>((e >> (c + 16)) & 0xFFFF));
        e &= n;
        s -= 8;
        c -= 8;
        n >>= 8;
      } while (s > 0);
    }
    if (static_cast<long>(pre.size()) > cap) return -1;
    uint32_t carry = 0;
    for (long i = static_cast<long>(pre.size()) - 1; i >= 0; --i) {
      uint32_t v = pre[i] + carry;
      out[i] = static_cast<uint8_t>(v & 0xFF);
      carry = v >> 8;
    }
    return static_cast<long>(pre.size());
  }
};

// spec §8.4 CDF update (twin of cdf_model.update_icdf)
inline void update_icdf(int32_t* icdf, int val, int nsyms) {
  static const int speed[17] = {0, 0, 1, 1, 2, 2, 2, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 2};
  int count = icdf[nsyms];
  int rate = 3 + (count > 15) + (count > 31) + speed[nsyms];
  int32_t tmp = 32768;
  for (int i = 0; i < nsyms - 1; ++i) {
    if (i == val) tmp = 0;
    int32_t c = icdf[i];
    icdf[i] = tmp < c ? c - ((c - tmp) >> rate) : c + ((tmp - c) >> rate);
  }
  icdf[nsyms] = count + (count < 32);
}

// ---------------------------------------------------------------------------
// CDF table blob layout (mirrored in entropy/backend.py TABLE_DIMS)
// ---------------------------------------------------------------------------
struct Tables {
  int32_t* kf_y_mode;     // [5][5][14]
  int32_t* angle_delta;   // [8][8]
  int32_t* uv_mode;       // [2][13][15]
  int32_t* partition;     // [20][11]
  int32_t* skip;          // [3][3]
  int32_t* intra_ext_tx;  // [3][4][13][17]
  int32_t* txb_skip;      // [5][13][3]
  int32_t* dc_sign;       // [2][3][3]
  int32_t* eob_extra;     // [5][2][22][3]
  int32_t* coeff_br;      // [5][2][21][5]
  int32_t* coeff_base;    // [5][2][42][5]
  int32_t* coeff_base_eob;  // [5][2][4][4]
  int32_t* eob_pt[7];     // 16..1024: [2][2][nsym+1], nsym = 5..11
  // inter (appended; twin of FrameContext inter members)
  int32_t* newmv;         // [6][3]
  int32_t* zeromv;        // [2][3]
  int32_t* refmv;         // [6][3]
  int32_t* drl;           // [3][3]
  int32_t* intra_inter;   // [4][3]
  int32_t* single_ref;    // [3][6][3]
  int32_t* inter_ext_tx;  // [4][4][17]
  int32_t* comp_inter;       // [5][3]
  int32_t* comp_ref_type;    // [5][3]
  int32_t* comp_ref;         // [3][3][3]
  int32_t* comp_bwdref;      // [3][2][3]
  int32_t* inter_comp_mode;  // [8][9]
  int32_t* nmv_joints;    // [5]
  int32_t* nmv_classes;   // [2][12]
  int32_t* nmv_class0_fp; // [2][2][5]
  int32_t* nmv_fp;        // [2][5]
  int32_t* nmv_sign;      // [2][3]
  int32_t* nmv_class0_hp; // [2][3]
  int32_t* nmv_hp;        // [2][3]
  int32_t* nmv_class0;    // [2][3]
  int32_t* nmv_bits;      // [2][10][3]
  int32_t* cfl_sign;      // [9]
  int32_t* cfl_alpha;     // [6][17]
  int32_t* delta_q;       // [5] (per-SB delta_q abs symbol)
};

constexpr long TABLE_SIZES[] = {
    5 * 5 * 14, 8 * 8, 2 * 13 * 15, 20 * 11, 3 * 3, 3 * 4 * 13 * 17,
    5 * 13 * 3, 2 * 3 * 3, 5 * 2 * 22 * 3, 5 * 2 * 21 * 5, 5 * 2 * 42 * 5,
    5 * 2 * 4 * 4,
    2 * 2 * 6, 2 * 2 * 7, 2 * 2 * 8, 2 * 2 * 9, 2 * 2 * 10, 2 * 2 * 11,
    2 * 2 * 12,
    6 * 3, 2 * 3, 6 * 3, 3 * 3, 4 * 3, 3 * 6 * 3, 4 * 4 * 17,
    5 * 3, 5 * 3, 3 * 3 * 3, 3 * 2 * 3, 8 * 9,
    5, 2 * 12, 2 * 2 * 5, 2 * 5, 2 * 3, 2 * 3, 2 * 3, 2 * 3, 2 * 10 * 3,
    9, 6 * 17, 5,
};
constexpr int N_TABLES = sizeof(TABLE_SIZES) / sizeof(long);

long total_table_size() {
  long t = 0;
  for (int i = 0; i < N_TABLES; ++i) t += TABLE_SIZES[i];
  return t;
}

void bind_tables(Tables* t, int32_t* blob) {
  int32_t* p = blob;
  int32_t** slots[] = {
      &t->kf_y_mode, &t->angle_delta, &t->uv_mode, &t->partition, &t->skip,
      &t->intra_ext_tx, &t->txb_skip, &t->dc_sign, &t->eob_extra,
      &t->coeff_br, &t->coeff_base, &t->coeff_base_eob,
      &t->eob_pt[0], &t->eob_pt[1], &t->eob_pt[2], &t->eob_pt[3],
      &t->eob_pt[4], &t->eob_pt[5], &t->eob_pt[6],
      &t->newmv, &t->zeromv, &t->refmv, &t->drl, &t->intra_inter,
      &t->single_ref, &t->inter_ext_tx,
      &t->comp_inter, &t->comp_ref_type, &t->comp_ref, &t->comp_bwdref,
      &t->inter_comp_mode,
      &t->nmv_joints, &t->nmv_classes, &t->nmv_class0_fp, &t->nmv_fp,
      &t->nmv_sign, &t->nmv_class0_hp, &t->nmv_hp, &t->nmv_class0,
      &t->nmv_bits, &t->cfl_sign, &t->cfl_alpha, &t->delta_q};
  for (int i = 0; i < N_TABLES; ++i) {
    *slots[i] = p;
    p += TABLE_SIZES[i];
  }
}

// ---------------------------------------------------------------------------
// Syntax constants (twins of entropy/syntax.py)
// ---------------------------------------------------------------------------
constexpr int PARTITION_NONE = 0, PARTITION_HORZ = 1, PARTITION_VERT = 2,
              PARTITION_SPLIT = 3, PARTITION_HORZ_A = 4, PARTITION_HORZ_B = 5,
              PARTITION_VERT_A = 6, PARTITION_VERT_B = 7, PARTITION_HORZ_4 = 8,
              PARTITION_VERT_4 = 9;
constexpr int V_PRED = 1, D67_PRED = 8, MAX_ANGLE_DELTA = 3;
const int EOB_GROUP_START[12] = {0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513};
const int EOB_OFFSET_BITS[12] = {0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9};
const uint8_t SKIP_CTX_TABLE[5][5] = {{1, 2, 2, 2, 3},
                                      {1, 4, 4, 4, 5},
                                      {1, 4, 4, 4, 5},
                                      {1, 4, 4, 4, 5},
                                      {1, 4, 4, 4, 6}};

// ext-tx: intra set DTT4_IDTX (reduced) has 5 syms; DCT_DCT -> symbol 1
// (EXT_TX_IND[2][0]); DTT4_IDTX_1DDCT (non-reduced) 7 syms, DCT_DCT -> 1.

inline int bit_length(uint32_t x) { return x ? 32 - __builtin_clz(x) : 0; }

void eob_pos_token(int eob, int* pt, int* extra) {
  int t = eob < 3 ? eob : bit_length(static_cast<uint32_t>(eob - 1)) + 1;
  *pt = t;
  *extra = eob - EOB_GROUP_START[t];
}

void write_golomb(RangeEncoder* enc, int level) {
  int x = level + 1;
  int len = bit_length(static_cast<uint32_t>(x));
  for (int i = 0; i < len - 1; ++i) enc->encode_bool(0, 16384);
  for (int i = len - 1; i >= 0; --i)
    enc->encode_bool((x >> i) & 1, 16384);
}

// zig-zag / diagonal scan generation (twin of tables.default_scan)
void build_scan(int rows, int cols, int tx_class, int16_t* scan) {
  if (tx_class == 2) {  // VERT -> mrow (raster)
    for (int i = 0; i < rows * cols; ++i) scan[i] = static_cast<int16_t>(i);
    return;
  }
  if (tx_class == 1) {  // HORIZ -> mcol (column-major)
    int k = 0;
    for (int c = 0; c < cols; ++c)
      for (int r = 0; r < rows; ++r) scan[k++] = static_cast<int16_t>(r * cols + c);
    return;
  }
  int k = 0;
  for (int d = 0; d < rows + cols - 1; ++d) {
    bool up = (rows == cols && d % 2 == 0) || rows < cols;
    if (up) {
      for (int r = std::min(d, rows - 1); r >= 0; --r) {
        int c = d - r;
        if (c >= 0 && c < cols) scan[k++] = static_cast<int16_t>(r * cols + c);
      }
    } else {
      for (int r = 0; r < rows; ++r) {
        int c = d - r;
        if (c >= 0 && c < cols) scan[k++] = static_cast<int16_t>(r * cols + c);
      }
    }
  }
}

// 2D-class base ctx offset rule (twin of syntax.nz_map_ctx_offset)
inline int nz_offset_2d(int r, int c, int w, int h) {
  if (r == 0 && c == 0) return 0;
  if (w < h) return r < 2 ? 11 : (r + c < 4 ? 6 : 21);
  if (w > h) return c < 2 ? 16 : (r + c < 4 ? 6 : 21);
  return r + c < 2 ? 1 : (r + c < 4 ? 6 : 21);
}

constexpr int TX_PAD_HOR = 4, TX_PAD_TOP = 2, TX_PAD_BOTTOM = 4;

struct LevelsBuf {  // padded |level| halo buffer
  uint8_t buf[(32 + TX_PAD_TOP + TX_PAD_BOTTOM) * (32 + TX_PAD_HOR)];
  int w, h, stride;
  void init(const int32_t* lv, int width, int height) {
    w = width;
    h = height;
    stride = width + TX_PAD_HOR;
    std::memset(buf, 0, sizeof(buf[0]) * (h + TX_PAD_TOP + TX_PAD_BOTTOM) * stride);
    uint8_t* p = buf + TX_PAD_TOP * stride;
    for (int r = 0; r < h; ++r)
      for (int c = 0; c < w; ++c) {
        int32_t v = lv[r * w + c];
        v = v < 0 ? -v : v;
        p[r * stride + c] = static_cast<uint8_t>(std::min(v, 127));
      }
  }
  inline uint8_t at(int r, int c) const {
    return buf[(r + TX_PAD_TOP) * stride + c];
  }
};

int base_ctx_at(const LevelsBuf& lb, int r, int c, int tx_class) {
  int mag;
  if (tx_class == 0) {
    mag = std::min<int>(lb.at(r, c + 1), 3) + std::min<int>(lb.at(r + 1, c), 3) +
          std::min<int>(lb.at(r, c + 2), 3) + std::min<int>(lb.at(r + 1, c + 1), 3) +
          std::min<int>(lb.at(r + 2, c), 3);
  } else if (tx_class == 1) {
    mag = std::min<int>(lb.at(r, c + 1), 3) + std::min<int>(lb.at(r + 1, c), 3) +
          std::min<int>(lb.at(r, c + 2), 3) + std::min<int>(lb.at(r, c + 3), 3) +
          std::min<int>(lb.at(r, c + 4), 3);
  } else {
    mag = std::min<int>(lb.at(r, c + 1), 3) + std::min<int>(lb.at(r + 1, c), 3) +
          std::min<int>(lb.at(r + 2, c), 3) + std::min<int>(lb.at(r + 3, c), 3) +
          std::min<int>(lb.at(r + 4, c), 3);
  }
  int count = std::min((mag + 1) >> 1, 4);
  if (tx_class == 0) return count + nz_offset_2d(r, c, lb.w, lb.h);
  int band = std::min(tx_class == 1 ? c : r, 2);
  return count + 26 + 5 * band;
}

int br_ctx_at(const LevelsBuf& lb, int r, int c, int tx_class) {
  int mag = lb.at(r, c + 1) + lb.at(r + 1, c);
  bool near;
  if (tx_class == 0) {
    mag += lb.at(r + 1, c + 1);
    near = r < 2 && c < 2;
  } else if (tx_class == 1) {
    mag += lb.at(r, c + 2);
    near = c == 0;
  } else {
    mag += lb.at(r + 2, c);
    near = r == 0;
  }
  mag = std::min((mag + 1) >> 1, 6);
  if (r == 0 && c == 0) return mag;
  return mag + (near ? 7 : 14);
}

// ---------------------------------------------------------------------------
// Tile writer (twin of pipeline/tile.py for P=8 uniform partition)
// ---------------------------------------------------------------------------
struct TileWriter {
  int mi_rows, mi_cols, qindex;
  bool reduced_tx_set;
  Tables t;
  std::vector<int32_t> blob;  // private CDF copy (adapts per tile)
  RangeEncoder enc;
  // neighbor state
  std::vector<uint8_t> part_above, part_left;
  std::vector<int8_t> y_modes, skips;        // mi grids
  std::vector<uint8_t> lvl_above[3], lvl_left[3];
  // per-frame data
  const uint8_t* modes;
  const int32_t *ly, *lu, *lvv;
  int nbw;
  // multi-size intra (16x16 leaves): per-cell size map + 16-leaf grids
  const uint8_t* isize_map = nullptr;  // [nbh][nbw] 8/16
  const int32_t *l16y = nullptr, *l16u = nullptr, *l16v = nullptr;

  void init(int mr, int mc, int q, int reduced, const int32_t* cdf_blob) {
    mi_rows = mr;
    mi_cols = mc;
    qindex = q;
    reduced_tx_set = reduced != 0;
    blob.assign(cdf_blob, cdf_blob + total_table_size());
    bind_tables(&t, blob.data());
    part_above.assign(mc, 0);
    part_left.assign(mr, 0);
    y_modes.assign(static_cast<size_t>(mr) * mc, 0);
    skips.assign(static_cast<size_t>(mr) * mc, 0);
    int cr = (mr + 1) >> 1, cc = (mc + 1) >> 1;
    lvl_above[0].assign(mc, 0);
    lvl_left[0].assign(mr, 0);
    for (int p = 1; p < 3; ++p) {
      lvl_above[p].assign(cc, 0);
      lvl_left[p].assign(cr, 0);
    }
    size_t n = static_cast<size_t>(mr) * mc;
    mi_inter.assign(n, 0);
    mi_mode.assign(n, 0);
    mi_w4.assign(n, 0);
    mi_h4.assign(n, 0);
    mi_ref.assign(n, 0);
    mi_ref2.assign(n, -1);
    mi_mv.assign(n * 2, 0);
    mi_mv2.assign(n * 2, 0);
    mi_valid.assign(n, 0);
  }

  // --- contexts ---
  int partition_ctx(int r4, int c4, int bsl) const {
    int above = (part_above[c4] >> bsl) & 1;
    int left = (part_left[r4] >> bsl) & 1;
    return (left * 2 + above) + bsl * 4;
  }

  static const int INTRA_MODE_CTX[13];

  void txb_ctx(int plane, int pr, int pc, int w4, int h4, int* skip_ctx,
               int* dc_ctx) const {
    const std::vector<uint8_t>& above = lvl_above[plane];
    const std::vector<uint8_t>& left = lvl_left[plane];
    bool have_above = pr > 0, have_left = pc > 0;
    static const int signs[3] = {0, -1, 1};
    int dc = 0;
    if (have_above)
      for (int i = 0; i < w4; ++i) dc += signs[above[pc + i] >> 6];
    if (have_left)
      for (int i = 0; i < h4; ++i) dc += signs[left[pr + i] >> 6];
    *dc_ctx = dc > 0 ? 2 : (dc < 0 ? 1 : 0);
    if (plane == 0) {
      *skip_ctx = 0;  // full-block tx
    } else {
      int tnz = 0, lnz = 0;
      if (have_above)
        for (int i = 0; i < w4; ++i) tnz += above[pc + i] != 0;
      if (have_left)
        for (int i = 0; i < h4; ++i) lnz += left[pr + i] != 0;
      *skip_ctx = (tnz != 0) + (lnz != 0) + 7;
    }
  }

  void set_txb(int plane, int pr, int pc, int w4, int h4, int cul) {
    for (int i = 0; i < w4; ++i) lvl_above[plane][pc + i] = static_cast<uint8_t>(cul);
    for (int i = 0; i < h4; ++i) lvl_left[plane][pr + i] = static_cast<uint8_t>(cul);
  }

  // --- partition symbols ---
  void write_partition(int r4, int c4, int n4, int p) {
    int half = n4 >> 1;
    bool has_rows = (r4 + half) < mi_rows;
    bool has_cols = (c4 + half) < mi_cols;
    int bsl = bit_length(static_cast<uint32_t>(n4 >> 1)) - 1;
    int32_t* cdf = t.partition + partition_ctx(r4, c4, bsl) * 11;
    int nsym = n4 == 2 ? 4 : (n4 == 32 ? 8 : 10);
    if (!has_rows && !has_cols) return;
    if (has_rows && has_cols) {
      enc.encode_symbol(p, cdf, nsym);
      update_icdf(cdf, p, nsym);
      return;
    }
    auto prob = [&](int e) {
      if (e >= nsym) return 0;
      int hi = e == 0 ? 32768 : cdf[e - 1];
      return hi - cdf[e];
    };
    int psum;
    if (!has_rows) {
      psum = prob(PARTITION_VERT) + prob(PARTITION_SPLIT) +
             prob(PARTITION_HORZ_A) + prob(PARTITION_VERT_A) +
             prob(PARTITION_VERT_B) + prob(PARTITION_VERT_4);
    } else {
      psum = prob(PARTITION_HORZ) + prob(PARTITION_SPLIT) +
             prob(PARTITION_HORZ_A) + prob(PARTITION_HORZ_B) +
             prob(PARTITION_VERT_A) + prob(PARTITION_HORZ_4);
    }
    int32_t bin[3] = {psum, 0, 0};
    enc.encode_symbol(p == PARTITION_SPLIT ? 1 : 0, bin, 2);
  }

  // --- coefficients (twin of syntax.write_coeffs_txb) ---
  int write_coeffs(const int32_t* lv, int w, int h, int txs_ctx, int plane_type,
                   int tx_type, int skip_ctx, int dc_ctx, bool tx_type_flag,
                   int y_mode) {
    return write_coeffs_impl(lv, w, h, txs_ctx, plane_type, tx_type, skip_ctx,
                             dc_ctx, tx_type_flag, y_mode, false);
  }

  int write_coeffs_impl(const int32_t* lv, int w, int h, int txs_ctx,
                        int plane_type, int tx_type, int skip_ctx, int dc_ctx,
                        bool tx_type_flag, int y_mode, bool is_inter) {
    int tx_class = (tx_type == 10 || tx_type == 12 || tx_type == 14) ? 2
                   : (tx_type == 11 || tx_type == 13 || tx_type == 15) ? 1 : 0;
    int16_t scan[1024];
    build_scan(h, w, tx_class, scan);
    int n = w * h;
    int eob = 0;
    for (int i = n - 1; i >= 0; --i)
      if (lv[scan[i]] != 0) {
        eob = i + 1;
        break;
      }
    int32_t* cdf = t.txb_skip + (txs_ctx * 13 + skip_ctx) * 3;
    enc.encode_symbol(eob == 0 ? 1 : 0, cdf, 2);
    update_icdf(cdf, eob == 0 ? 1 : 0, 2);
    if (eob == 0) return 0;

    if (tx_type_flag && plane_type == 0 && qindex > 0) {
      if (is_inter) {
        // inter ext-tx, reduced set: DCT_IDTX (2 syms, eset 3); DCT -> 1
        int sq = w == 4 ? 0 : (w == 8 ? 1 : (w == 16 ? 2 : 3));
        int32_t* c2 = t.inter_ext_tx + (3 * 4 + sq) * 17;
        static const int IND_DCT_IDTX[16] = {1, 0, 0, 0, 0, 0, 0, 0,
                                             0, 0, 0, 0, 0, 0, 0, 0};
        int s = IND_DCT_IDTX[tx_type];
        enc.encode_symbol(s, c2, 2);
        update_icdf(c2, s, 2);
      } else {
        // intra ext-tx (sqr_up <= TX_16X16): set DTT4_IDTX (reduced, or
        // any 16x16) or DTT4_IDTX_1DDCT; DCT_DCT is symbol 1 in both
        // (syntax.py intra_tx_set_type)
        int sq = w == 4 ? 0 : (w == 8 ? 1 : 2);  // txsize_sqr idx
        bool dtt4 = reduced_tx_set || sq == 2;
        int nsym = dtt4 ? 5 : 7;
        int eset = dtt4 ? 2 : 1;
        int32_t* c2 = t.intra_ext_tx + ((eset * 4 + sq) * 13 + y_mode) * 17;
        static const int IND_DTT4_IDTX[16] = {1, 3, 4, 2, 0, 0, 0, 0,
                                              0, 0, 0, 0, 0, 0, 0, 0};
        static const int IND_DTT4_IDTX_1D[16] = {1, 5, 6, 4, 0, 0, 0, 0,
                                                 0, 0, 2, 3, 0, 0, 0, 0};
        int s = dtt4 ? IND_DTT4_IDTX[tx_type]
                     : IND_DTT4_IDTX_1D[tx_type];
        enc.encode_symbol(s, c2, nsym);
        update_icdf(c2, s, nsym);
      }
    }

    int pt, extra;
    eob_pos_token(eob, &pt, &extra);
    int ms = bit_length(static_cast<uint32_t>(n)) - 5;
    int nsym = 5 + ms;
    int32_t* ecdf = t.eob_pt[ms] +
                    (plane_type * 2 + (tx_class == 0 ? 0 : 1)) * (nsym + 1);
    enc.encode_symbol(pt - 1, ecdf, nsym);
    update_icdf(ecdf, pt - 1, nsym);
    int nbits = EOB_OFFSET_BITS[pt];
    if (nbits > 0) {
      int bit = (extra >> (nbits - 1)) & 1;
      int32_t* xcdf = t.eob_extra + ((txs_ctx * 2 + plane_type) * 22 + pt) * 3;
      enc.encode_symbol(bit, xcdf, 2);
      update_icdf(xcdf, bit, 2);
      for (int i = 1; i < nbits; ++i)
        enc.encode_bool((extra >> (nbits - 1 - i)) & 1, 16384);
    }

    LevelsBuf lb;
    lb.init(lv, w, h);

    for (int ci = eob - 1; ci >= 0; --ci) {
      int pos = scan[ci];
      int row = pos / w, col = pos % w;
      int32_t v = lv[pos];
      int level = v < 0 ? -v : v;
      if (ci == eob - 1) {
        int ctx = ci == 0 ? 0 : (ci <= n / 8 ? 1 : (ci <= n / 4 ? 2 : 3));
        int32_t* c2 = t.coeff_base_eob + ((txs_ctx * 2 + plane_type) * 4 + ctx) * 4;
        int s = std::min(level, 3) - 1;
        enc.encode_symbol(s, c2, 3);
        update_icdf(c2, s, 3);
      } else {
        int ctx = base_ctx_at(lb, row, col, tx_class);
        int32_t* c2 = t.coeff_base + ((txs_ctx * 2 + plane_type) * 42 + ctx) * 5;
        int s = std::min(level, 3);
        enc.encode_symbol(s, c2, 4);
        update_icdf(c2, s, 4);
      }
      if (level > 2) {
        int base_range = level - 3;
        int ctx = br_ctx_at(lb, row, col, tx_class);
        int32_t* c2 = t.coeff_br +
                      ((std::min(txs_ctx, 3) * 2 + plane_type) * 21 + ctx) * 5;
        for (int idx = 0; idx < 12; idx += 3) {
          int k = std::min(base_range - idx, 3);
          enc.encode_symbol(k, c2, 4);
          update_icdf(c2, k, 4);
          if (k < 3) break;
        }
      }
    }

    int cul = 0;
    for (int ci = 0; ci < eob; ++ci) {
      int pos = scan[ci];
      int32_t v = lv[pos];
      if (v == 0) continue;
      int level = v < 0 ? -v : v;
      cul += level;
      int sign = v < 0 ? 1 : 0;
      if (ci == 0) {
        int32_t* c2 = t.dc_sign + (plane_type * 3 + dc_ctx) * 3;
        enc.encode_symbol(sign, c2, 2);
        update_icdf(c2, sign, 2);
      } else {
        enc.encode_bool(sign, 16384);
      }
      if (level > 14) write_golomb(&enc, level - 15);
    }
    cul = std::min(cul, 63);
    if (lv[0] < 0)
      cul |= 1 << 6;
    else if (lv[0] > 0)
      cul += 2 << 6;
    return cul;
  }

  void write_cdef_idx(int r4, int c4, bool skip) {
    // ref write_cdef: literal bits at the first non-skip block per 64x64
    if (cdef_idx == nullptr || cdef_done || skip) return;
    int idx = cdef_idx[static_cast<size_t>(r4 / 16) * nsb_w + (c4 / 16)];
    for (int b = cdef_bits - 1; b >= 0; --b)
      enc.encode_bool((idx >> b) & 1, 16384);
    cdef_done = true;
  }

  void write_delta_q(int r4, int c4, int n4, bool skip) {
    // spec read_delta_qindex: first block of each SB, after the cdef
    // index; an SB-sized skip block codes nothing (twin of
    // pipeline/tile.py _write_delta_q + syntax code_delta_q)
    if (qmap == nullptr || dq_done) return;
    if ((r4 & 15) || (c4 & 15)) return;
    dq_done = true;
    if (n4 == 16 && skip) return;
    const int target = qmap[static_cast<size_t>(r4 / 16) * nsb_w + c4 / 16];
    // arithmetic shift (floor), matching the Python twin; targets are
    // asserted step-aligned at the backend boundary
    const int delta = (target - cur_q) >> dq_res;
    int a = delta < 0 ? -delta : delta;
    const int sym = a < 3 ? a : 3;
    code_sym(t.delta_q, sym, 4);
    if (sym == 3) {
      const int n = 31 - __builtin_clz(static_cast<unsigned>(a - 1));
      for (int i = 2; i >= 0; --i)
        enc.encode_bool(((n - 1) >> i) & 1, 16384);
      const int bits = a - 1 - (1 << n);
      for (int i = n - 1; i >= 0; --i)
        enc.encode_bool((bits >> i) & 1, 16384);
    }
    if (a) enc.encode_bool(delta < 0 ? 1 : 0, 16384);
    // mirror the decoder's Clip3(1, 255, ...) on CurrentQIndex
    cur_q += delta << dq_res;
    if (cur_q < 1) cur_q = 1;
    if (cur_q > 255) cur_q = 255;
  }

  // --- intra leaf (8x8, or 16x16 from the multi-size wavefront) ---
  void write_block(int r4, int c4, int n4 = 2) {
    int br = r4 >> 1, bc = c4 >> 1;
    int y_mode = modes[br * nbw + bc];
    const int32_t *l0, *l1, *l2;
    int ny, nc;
    if (n4 == 2) {
      l0 = ly + (static_cast<long>(br) * nbw + bc) * 64;
      l1 = lu + (static_cast<long>(br) * nbw + bc) * 16;
      l2 = lvv + (static_cast<long>(br) * nbw + bc) * 16;
      ny = 64;
      nc = 16;
    } else {
      const int nuw = (nbw + 1) >> 1;
      const long u = static_cast<long>(r4 >> 2) * nuw + (c4 >> 2);
      l0 = l16y + u * 256;
      l1 = l16u + u * 64;
      l2 = l16v + u * 64;
      ny = 256;
      nc = 64;
    }
    bool skip = true;
    for (int i = 0; i < ny && skip; ++i) skip = l0[i] == 0;
    for (int i = 0; i < nc && skip; ++i) skip = l1[i] == 0 && l2[i] == 0;

    // skip flag
    int above = r4 > 0 ? skips[(r4 - 1) * mi_cols + c4] : 0;
    int left = c4 > 0 ? skips[r4 * mi_cols + c4 - 1] : 0;
    int32_t* cdf = t.skip + (above + left) * 3;
    enc.encode_symbol(skip ? 1 : 0, cdf, 2);
    update_icdf(cdf, skip ? 1 : 0, 2);
    write_cdef_idx(r4, c4, skip);

    // y mode
    int am = r4 > 0 ? y_modes[(r4 - 1) * mi_cols + c4] : 0;
    int lm = c4 > 0 ? y_modes[r4 * mi_cols + c4 - 1] : 0;
    cdf = t.kf_y_mode + (INTRA_MODE_CTX[am] * 5 + INTRA_MODE_CTX[lm]) * 14;
    enc.encode_symbol(y_mode, cdf, 13);
    update_icdf(cdf, y_mode, 13);
    if (y_mode >= V_PRED && y_mode <= D67_PRED) {
      int delta = angles_map
                      ? static_cast<const int8_t*>(
                            static_cast<const void*>(angles_map))
                            [static_cast<size_t>(r4 >> 1) * nbw + (c4 >> 1)]
                      : 0;
      cdf = t.angle_delta + (y_mode - V_PRED) * 8;
      enc.encode_symbol(delta + MAX_ANGLE_DELTA, cdf, 7);
      update_icdf(cdf, delta + MAX_ANGLE_DELTA, 7);
    }
    // uv mode (cfl-allowed context at 8x8)
    int uv = uv_map
                 ? uv_map[static_cast<size_t>(r4 >> 1) * nbw + (c4 >> 1)]
                 : 0;
    cdf = t.uv_mode + (1 * 13 + y_mode) * 15;
    enc.encode_symbol(uv, cdf, 14);
    update_icdf(cdf, uv, 14);
    if (uv == 13 && cfl_map) {  // UV_CFL_PRED: joint sign + magnitudes
      int au = static_cast<const int8_t*>(
          static_cast<const void*>(cfl_map))
          [(static_cast<size_t>(r4 >> 1) * nbw + (c4 >> 1)) * 2];
      int av = static_cast<const int8_t*>(
          static_cast<const void*>(cfl_map))
          [(static_cast<size_t>(r4 >> 1) * nbw + (c4 >> 1)) * 2 + 1];
      int su_ = au == 0 ? 0 : (au > 0 ? 2 : 1);
      int sv_ = av == 0 ? 0 : (av > 0 ? 2 : 1);
      int joint = su_ * 3 + sv_ - 1;
      code_sym(t.cfl_sign, joint, 8);
      if (su_) {
        int mag = (au > 0 ? au : -au) - 1;
        code_sym(t.cfl_alpha + (joint - 2) * 17, mag, 16);
      }
      if (sv_) {
        int mag = (av > 0 ? av : -av) - 1;
        code_sym(t.cfl_alpha + (sv_ * 3 + su_ - 3) * 17, mag, 16);
      }
    }
    if (uv >= V_PRED && uv <= D67_PRED) {  // angle_delta_uv (always 0)
      cdf = t.angle_delta + (uv - V_PRED) * 8;
      enc.encode_symbol(MAX_ANGLE_DELTA, cdf, 7);
      update_icdf(cdf, MAX_ANGLE_DELTA, 7);
    }

    // grids + partition neighbor bytes
    for (int i = 0; i < n4; ++i) {
      for (int j = 0; j < n4; ++j) {
        y_modes[(r4 + i) * mi_cols + c4 + j] = static_cast<int8_t>(y_mode);
        skips[(r4 + i) * mi_cols + c4 + j] = skip ? 1 : 0;
      }
    }
    for (int j = 0; j < n4; ++j) part_above[c4 + j] = 32 - n4;
    for (int i = 0; i < n4; ++i) part_left[r4 + i] = 32 - n4;

    // residuals
    const int32_t* lvs[3] = {l0, l1, l2};
    for (int plane = 0; plane < 3; ++plane) {
      int pr = plane ? r4 >> 1 : r4;
      int pc = plane ? c4 >> 1 : c4;
      int w4 = plane ? n4 >> 1 : n4;
      if (skip) {
        set_txb(plane, pr, pc, w4, w4, 0);
        continue;
      }
      int sctx, dctx;
      txb_ctx(plane, pr, pc, w4, w4, &sctx, &dctx);
      int bs = plane ? n4 * 2 : n4 * 4;
      int txs_ctx = bs == 4 ? 0 : (bs == 8 ? 1 : 2);
      int cul = write_coeffs(lvs[plane], bs, bs, txs_ctx, plane ? 1 : 0, 0,
                             sctx, dctx, plane == 0, y_mode);
      set_txb(plane, pr, pc, w4, w4, cul);
    }
  }

  // =========================================================================
  // Inter frame path (twin of pipeline/tile.py encode_inter + entropy/mvp.py)
  // =========================================================================
  bool inter_frame = false;
  const uint8_t* cdef_idx = nullptr;  // [nsb_h][nsb_w] strength index
  int cdef_bits = 2;
  int nsb_w = 0;
  bool cdef_done = false;             // per-64x64 first-non-skip flag
  // per-SB delta-q (spec read_delta_qindex): absolute qindex targets
  const int32_t* qmap = nullptr;      // [nsb_h][nsb_w]
  int dq_res = 0;
  int cur_q = 0;                      // CurrentQIndex state machine
  bool dq_done = false;               // per-SB first-block flag
  const int32_t* mvs = nullptr;      // [nb8h][nb8w][2] 1/8-pel (selected)
  const uint8_t* ref_map = nullptr;  // [nb8h][nb8w] ref type 1..7 (LAST..
                                     // ALTREF); 0 = compound cell;
                                     // null = all LAST (flat P)
  const int32_t* mvs2 = nullptr;
  const uint8_t* txty_map = nullptr;
  const uint8_t* angles_map = nullptr;  // per-block angle delta (int8)
  const uint8_t* uv_map = nullptr;      // per-block chroma mode
  const uint8_t* cfl_map = nullptr;     // [nbh][nbw][2] int8 alphaQ3
  int ref_select = 0;                // frame codes comp_inter bits
  int comp_fwd = 1, comp_bwd = 7;    // frame-level BIDIR pair
  const uint8_t* size_map = nullptr; // [nb8h][nb8w] leaf size 8..64
  const int32_t* lv_inter[4][3];     // [size8/16/32/64][plane] level grids
  // packed per-8x8-cell level tiles (the device step's native layout:
  // [nb8h][nb8w][8x8] luma / [4x4] chroma int16) — when set, leaves
  // materialize their level grids from cell tiles and lv_inter stays
  // null, sparing the host the 12 per-size full-frame unpacks
  const int16_t* lv_pack[3] = {nullptr, nullptr, nullptr};
  int nb8w = 0;
  // per-mi inter grids (twin of MiInter)
  std::vector<uint8_t> mi_inter, mi_mode, mi_w4, mi_h4;
  std::vector<int8_t> mi_ref;
  std::vector<int8_t> mi_ref2;           // -1 = single-ref block
  std::vector<int16_t> mi_mv;            // [mr*mc*2] (row, col) 1/8 pel
  std::vector<int16_t> mi_mv2;           // compound second MV
  uint8_t sign_bias[8] = {0};            // per ref type (backward = 1)
  std::vector<int8_t> mi_valid;          // coded yet (tc.mi_sizes >= 0)

  static constexpr int NEWMV = 16, NEARESTMV = 13, NEARMV = 14, GLOBALMV = 15;
  static constexpr int REF_CAT_LEVEL = 640, MAX_STACK = 8;
  static constexpr int LAST_FRAME = 1;

  struct Cand { int16_t mv[2]; int16_t mv2[2]; int32_t weight; };

  struct StackResult {
    Cand stack[MAX_STACK + 2];
    int num_found = 0;      // real count (drl gating)
    int num_nearest = 0;
    int mode_context = 0;
    int newmv_ctx() const { return mode_context & 7; }
    int zeromv_ctx() const { return (mode_context >> 3) & 1; }
    int refmv_ctx() const { return (mode_context >> 4) & 15; }
    int drl_ctx(int idx) const {
      int w0 = stack[idx].weight, w1 = stack[idx + 1].weight;
      if (w0 >= REF_CAT_LEVEL && w1 >= REF_CAT_LEVEL) return 0;
      if (w0 >= REF_CAT_LEVEL && w1 < REF_CAT_LEVEL) return 1;
      if (w0 < REF_CAT_LEVEL && w1 < REF_CAT_LEVEL) return 2;
      return 0;
    }
  };

  static int has_top_right(int sb_mi, int mi_row, int mi_col, int w4, int h4) {
    int bs = std::max(w4, h4);
    if (bs > 16) return 0;
    int mask_row = mi_row & (sb_mi - 1);
    int mask_col = mi_col & (sb_mi - 1);
    int has_tr = !((mask_row & bs) && (mask_col & bs));
    for (int b = bs; b < sb_mi; b <<= 1) {
      if (mask_col & b) {
        if ((mask_col & (2 * b)) && (mask_row & (2 * b))) { has_tr = 0; break; }
      } else {
        break;
      }
    }
    if (w4 < h4) has_tr = 1;
    if (w4 > h4) has_tr = 0;
    return has_tr;
  }

  // global motion (TRANSLATION only): per ref-type 1..7 active flag +
  // translation (row, col) in 1/8-pel; pads the ref-MV stack and backs
  // GLOBALMV exactly like the Python twin (entropy/mvp.py _find_stack)
  const uint8_t* gm_type = nullptr;   // [7] or null
  const int32_t* gm_vec = nullptr;    // [7][2] or null

  void find_mv_stack(int mi_row, int mi_col, int w4, int h4,
                     StackResult* out, int ref_frame = LAST_FRAME,
                     int ref2 = -1, int gmr = 0, int gmc = 0) const {
    const bool is_comp = ref2 > 0;
    Cand stack[MAX_STACK];
    int n_stack = 0;
    int newmv_count = 0, row_match = 0, col_match = 0;

    auto is_newmv_mode = [](int m) {
      return m == NEWMV || (m >= 19 && m <= 22) || m == 24;
    };
    auto add_cand = [&](int r, int c, int len, int weight,
                        bool count_newmv) -> bool {
      size_t p = static_cast<size_t>(r) * mi_cols + c;
      if (!mi_inter[p]) return false;
      bool matched = false;
      if (is_comp) {
        // compound path: both refs must match the pair
        if (mi_ref[p] == ref_frame && mi_ref2[p] == ref2) {
          matched = true;
          int16_t m0r = mi_mv[p * 2], m0c = mi_mv[p * 2 + 1];
          int16_t m1r = mi_mv2[p * 2], m1c = mi_mv2[p * 2 + 1];
          int i = 0;
          for (; i < n_stack; ++i)
            if (stack[i].mv[0] == m0r && stack[i].mv[1] == m0c &&
                stack[i].mv2[0] == m1r && stack[i].mv2[1] == m1c) {
              stack[i].weight += weight * len;
              break;
            }
          if (i == n_stack && n_stack < MAX_STACK) {
            stack[n_stack].mv[0] = m0r;
            stack[n_stack].mv[1] = m0c;
            stack[n_stack].mv2[0] = m1r;
            stack[n_stack].mv2[1] = m1c;
            stack[n_stack].weight = weight * len;
            ++n_stack;
          }
          if (count_newmv && is_newmv_mode(mi_mode[p])) ++newmv_count;
        }
        return matched;
      }
      // either reference slot of the neighbor may match (ref
      // add_ref_mv_candidate single path: for ref in 0..1)
      for (int slot = 0; slot < 2; ++slot) {
        int cref = slot ? mi_ref2[p] : mi_ref[p];
        if (cref != ref_frame) continue;
        matched = true;
        int16_t mr = slot ? mi_mv2[p * 2] : mi_mv[p * 2];
        int16_t mc2 = slot ? mi_mv2[p * 2 + 1] : mi_mv[p * 2 + 1];
        int i = 0;
        for (; i < n_stack; ++i)
          if (stack[i].mv[0] == mr && stack[i].mv[1] == mc2) {
            stack[i].weight += weight * len;
            break;
          }
        if (i == n_stack && n_stack < MAX_STACK) {
          stack[n_stack].mv[0] = mr;
          stack[n_stack].mv[1] = mc2;
          stack[n_stack].weight = weight * len;
          ++n_stack;
        }
        if (count_newmv && is_newmv_mode(mi_mode[p])) ++newmv_count;
      }
      return matched;
    };

    bool row_adj = (h4 < 2) && (mi_row & 1);
    bool col_adj = (w4 < 2) && (mi_col & 1);
    int max_row_offset = 0, max_col_offset = 0;
    if (mi_row > 0) {
      max_row_offset = h4 < 2 ? -4 + row_adj : -6 + row_adj;
      max_row_offset = std::max(max_row_offset, -mi_row);
    }
    if (mi_col > 0) {
      max_col_offset = w4 < 2 ? -4 + col_adj : -6 + col_adj;
      max_col_offset = std::max(max_col_offset, -mi_col);
    }
    int processed_rows = 0, processed_cols = 0;

    auto scan_row = [&](int row_offset, bool count_newmv) {
      int end_mi = std::min(std::min(w4, mi_cols - mi_col), 16);
      int col_off = 0;
      if (std::abs(row_offset) > 1) {
        col_off = 1;
        if ((mi_col & 1) && w4 < 2) --col_off;
      }
      bool use_step_16 = w4 >= 16;
      for (int i = 0; i < end_mi;) {
        int r = mi_row + row_offset, c = mi_col + col_off + i;
        if (c >= mi_cols) break;
        size_t p = static_cast<size_t>(r) * mi_cols + c;
        int cw4 = std::max<int>(1, mi_w4[p]);
        int len = std::min(w4, cw4);
        if (use_step_16) len = std::max(4, len);
        else if (std::abs(row_offset) > 1) len = std::max(2, len);
        int weight = 2;
        if (2 <= w4 && w4 <= cw4) {
          int inc = std::min(-max_row_offset + row_offset + 1,
                             std::max<int>(1, mi_h4[p]));
          weight = std::max(weight, inc);
          processed_rows = inc - row_offset - 1;
        }
        if (add_cand(r, c, len, weight, count_newmv)) ++row_match;
        i += len;
      }
    };
    auto scan_col = [&](int col_offset, bool count_newmv) {
      int end_mi = std::min(std::min(h4, mi_rows - mi_row), 16);
      int row_off = 0;
      if (std::abs(col_offset) > 1) {
        row_off = 1;
        if ((mi_row & 1) && h4 < 2) --row_off;
      }
      bool use_step_16 = h4 >= 16;
      for (int i = 0; i < end_mi;) {
        int r = mi_row + row_off + i, c = mi_col + col_offset;
        if (r >= mi_rows) break;
        size_t p = static_cast<size_t>(r) * mi_cols + c;
        int ch4 = std::max<int>(1, mi_h4[p]);
        int len = std::min(h4, ch4);
        if (use_step_16) len = std::max(4, len);
        else if (std::abs(col_offset) > 1) len = std::max(2, len);
        int weight = 2;
        if (2 <= h4 && h4 <= ch4) {
          int inc = std::min(-max_col_offset + col_offset + 1,
                             std::max<int>(1, mi_w4[p]));
          weight = std::max(weight, inc);
          processed_cols = inc - col_offset - 1;
        }
        if (add_cand(r, c, len, weight, count_newmv)) ++col_match;
        i += len;
      }
    };
    auto scan_point = [&](int ro, int co, bool count_newmv) {
      int r = mi_row + ro, c = mi_col + co;
      if (r >= 0 && r < mi_rows && c >= 0 && c < mi_cols)
        if (add_cand(r, c, 2, 2, count_newmv)) ++row_match;
    };

    if (std::abs(max_row_offset) >= 1) scan_row(-1, true);
    if (std::abs(max_col_offset) >= 1) scan_col(-1, true);
    if (has_top_right(16, mi_row, mi_col, w4, h4)) scan_point(-1, w4, true);

    int nearest_match = (row_match > 0) + (col_match > 0);
    int num_nearest = n_stack;
    for (int i = 0; i < n_stack; ++i) stack[i].weight += REF_CAT_LEVEL;

    scan_point(-1, -1, false);
    for (int idx = 2; idx <= 3; ++idx) {
      int row_offset = -(idx << 1) + 1 + row_adj;
      int col_offset = -(idx << 1) + 1 + col_adj;
      if (std::abs(row_offset) <= std::abs(max_row_offset) &&
          std::abs(row_offset) > processed_rows)
        scan_row(row_offset, false);
      if (std::abs(col_offset) <= std::abs(max_col_offset) &&
          std::abs(col_offset) > processed_cols)
        scan_col(col_offset, false);
    }

    int total_matches = (row_match > 0) + (col_match > 0);
    int mode_context;
    if (nearest_match == 0) {
      mode_context = std::min(total_matches, 1);
      if (total_matches == 1) mode_context |= 1 << 4;
      else if (total_matches >= 2) mode_context |= 2 << 4;
    } else if (nearest_match == 1) {
      mode_context = newmv_count > 0 ? 2 : 3;
      if (total_matches == 1) mode_context |= 3 << 4;
      else if (total_matches >= 2) mode_context |= 4 << 4;
    } else {
      mode_context = newmv_count >= 1 ? 4 : 5;
      mode_context |= 5 << 4;
    }

    auto bubble = [&](int lo, int hi) {
      int len = hi;
      while (len > lo) {
        int nr_len = lo;
        for (int i = lo + 1; i < len; ++i)
          if (stack[i - 1].weight < stack[i].weight) {
            std::swap(stack[i - 1], stack[i]);
            nr_len = i;
          }
        len = nr_len;
      }
    };
    bubble(0, num_nearest);
    bubble(num_nearest, n_stack);

    if (is_comp && n_stack < 2) {
      // compound extension (mirror of mvp._find_stack comp branch):
      // exact-ref and sign-corrected other-ref candidates per side
      int mi_w = std::min(std::min(16, w4), mi_cols - mi_col);
      int mi_h = std::min(std::min(16, h4), mi_rows - mi_row);
      int mi_size = std::min(mi_w, mi_h);
      int16_t ref_id[2][2][2], ref_diff[2][2][2];
      int n_id[2] = {0, 0}, n_diff[2] = {0, 0};
      const int rfpair[2] = {ref_frame, ref2};
      auto gather = [&](bool row_scan) {
        for (int idx = 0; idx < mi_size;) {
          int r, c, step;
          if (row_scan) {
            r = mi_row - 1;
            c = mi_col + idx;
            step = std::max<int>(1,
                mi_w4[static_cast<size_t>(r) * mi_cols + c]);
          } else {
            r = mi_row + idx;
            c = mi_col - 1;
            step = std::max<int>(1,
                mi_h4[static_cast<size_t>(r) * mi_cols + c]);
          }
          size_t p = static_cast<size_t>(r) * mi_cols + c;
          if (mi_inter[p]) {
            for (int slot = 0; slot < 2; ++slot) {
              int cref = slot ? mi_ref2[p] : mi_ref[p];
              if (cref <= 0) continue;
              int16_t mr = slot ? mi_mv2[p * 2] : mi_mv[p * 2];
              int16_t mc2 = slot ? mi_mv2[p * 2 + 1] : mi_mv[p * 2 + 1];
              for (int side = 0; side < 2; ++side) {
                if (cref == rfpair[side] && n_id[side] < 2) {
                  ref_id[side][n_id[side]][0] = mr;
                  ref_id[side][n_id[side]][1] = mc2;
                  ++n_id[side];
                } else if (cref > 0 && n_diff[side] < 2) {
                  int16_t fr = mr, fc = mc2;
                  if (sign_bias[cref] != sign_bias[rfpair[side]]) {
                    fr = static_cast<int16_t>(-fr);
                    fc = static_cast<int16_t>(-fc);
                  }
                  ref_diff[side][n_diff[side]][0] = fr;
                  ref_diff[side][n_diff[side]][1] = fc;
                  ++n_diff[side];
                }
              }
            }
          }
          idx += step;
        }
      };
      if (std::abs(max_row_offset) >= 1) gather(true);
      if (std::abs(max_col_offset) >= 1) gather(false);
      int16_t comp_list[3][2][2] = {{{0}}};
      for (int side = 0; side < 2; ++side) {
        int ci = 0;
        for (int li = 0; li < n_id[side] && ci < 3; ++li, ++ci) {
          comp_list[ci][side][0] = ref_id[side][li][0];
          comp_list[ci][side][1] = ref_id[side][li][1];
        }
        for (int li = 0; li < n_diff[side] && ci < 3; ++li, ++ci) {
          comp_list[ci][side][0] = ref_diff[side][li][0];
          comp_list[ci][side][1] = ref_diff[side][li][1];
        }
        for (; ci < 3; ++ci) {
          comp_list[ci][side][0] = 0;
          comp_list[ci][side][1] = 0;
        }
      }
      if (n_stack) {
        int pick = (comp_list[0][0][0] == stack[0].mv[0] &&
                    comp_list[0][0][1] == stack[0].mv[1] &&
                    comp_list[0][1][0] == stack[0].mv2[0] &&
                    comp_list[0][1][1] == stack[0].mv2[1]) ? 1 : 0;
        stack[n_stack].mv[0] = comp_list[pick][0][0];
        stack[n_stack].mv[1] = comp_list[pick][0][1];
        stack[n_stack].mv2[0] = comp_list[pick][1][0];
        stack[n_stack].mv2[1] = comp_list[pick][1][1];
        stack[n_stack].weight = 2;
        ++n_stack;
      } else {
        for (int idx = 0; idx < 2; ++idx) {
          stack[n_stack].mv[0] = comp_list[idx][0][0];
          stack[n_stack].mv[1] = comp_list[idx][0][1];
          stack[n_stack].mv2[0] = comp_list[idx][1][0];
          stack[n_stack].mv2[1] = comp_list[idx][1][1];
          stack[n_stack].weight = 2;
          ++n_stack;
        }
      }
    } else if (!is_comp && n_stack < 2) {
      int mi_w = std::min(std::min(16, w4), mi_cols - mi_col);
      int mi_h = std::min(std::min(16, h4), mi_rows - mi_row);
      int mi_size = std::min(mi_w, mi_h);
      auto relaxed = [&](bool row_scan) {
        for (int idx = 0; idx < mi_size && n_stack < 2;) {
          int r, c, step;
          if (row_scan) {
            r = mi_row - 1;
            c = mi_col + idx;
            step = std::max<int>(1, mi_w4[static_cast<size_t>(r) * mi_cols + c]);
          } else {
            r = mi_row + idx;
            c = mi_col - 1;
            step = std::max<int>(1, mi_h4[static_cast<size_t>(r) * mi_cols + c]);
          }
          size_t p = static_cast<size_t>(r) * mi_cols + c;
          if (mi_inter[p]) {
            for (int slot = 0; slot < 2; ++slot) {
              int cref = slot ? mi_ref2[p] : mi_ref[p];
              if (cref <= 0) continue;
              int16_t mr = slot ? mi_mv2[p * 2] : mi_mv[p * 2];
              int16_t mc2 = slot ? mi_mv2[p * 2 + 1] : mi_mv[p * 2 + 1];
              if (sign_bias[cref] != sign_bias[ref_frame]) {
                mr = static_cast<int16_t>(-mr);
                mc2 = static_cast<int16_t>(-mc2);
              }
              // NOTE: the <2 guard is at the candidate level (outer
              // loop), so both slots of one candidate may append —
              // count can reach 3 here, exactly like the reference
              bool dup = false;
              for (int i = 0; i < n_stack; ++i)
                if (stack[i].mv[0] == mr && stack[i].mv[1] == mc2) dup = true;
              if (!dup && n_stack < MAX_STACK) {
                stack[n_stack].mv[0] = mr;
                stack[n_stack].mv[1] = mc2;
                stack[n_stack].weight = 2;
                ++n_stack;
              }
            }
          }
          idx += step;
        }
      };
      if (std::abs(max_row_offset) >= 1) relaxed(true);
      if (std::abs(max_col_offset) >= 1) relaxed(false);
    }

    out->num_found = n_stack;
    out->num_nearest = num_nearest;
    out->mode_context = mode_context;
    // clamp + pad with global (zero) mv
    int bw8 = w4 * 32, bh8 = h4 * 32;
    int lo_row = -(mi_row * 32) - bh8 - 128;
    int hi_row = (mi_rows - h4 - mi_row) * 32 + bh8 + 128;
    int lo_col = -(mi_col * 32) - bw8 - 128;
    int hi_col = (mi_cols - w4 - mi_col) * 32 + bw8 + 128;
    int n_out = std::max(n_stack, 2);
    for (int i = 0; i < n_out; ++i) {
      if (i < n_stack) {
        int r = std::min(std::max<int>(stack[i].mv[0], lo_row), hi_row);
        int c = std::min(std::max<int>(stack[i].mv[1], lo_col), hi_col);
        out->stack[i].mv[0] = static_cast<int16_t>(r);
        out->stack[i].mv[1] = static_cast<int16_t>(c);
        if (is_comp) {
          int r2 = std::min(std::max<int>(stack[i].mv2[0], lo_row), hi_row);
          int c2 = std::min(std::max<int>(stack[i].mv2[1], lo_col), hi_col);
          out->stack[i].mv2[0] = static_cast<int16_t>(r2);
          out->stack[i].mv2[1] = static_cast<int16_t>(c2);
        } else {
          out->stack[i].mv2[0] = 0;
          out->stack[i].mv2[1] = 0;
        }
        out->stack[i].weight = stack[i].weight;
      } else {
        out->stack[i].mv[0] = static_cast<int16_t>(gmr);
        out->stack[i].mv[1] = static_cast<int16_t>(gmc);
        out->stack[i].mv2[0] = 0;
        out->stack[i].mv2[1] = 0;
        out->stack[i].weight = 2;
      }
    }
  }

  inline void code_bin(int32_t* cdf, int val) {
    enc.encode_symbol(val, cdf, 2);
    update_icdf(cdf, val, 2);
  }
  inline void code_sym(int32_t* cdf, int val, int nsym) {
    enc.encode_symbol(val, cdf, nsym);
    update_icdf(cdf, val, nsym);
  }

  void encode_mv_component(int comp, int comp_idx, int precision) {
    int sign = comp < 0;
    int mag = sign ? -comp : comp;
    int z = mag - 1;
    int mv_class = z >= 2 * 4096 ? 10
                   : std::max(0, bit_length(static_cast<uint32_t>(z >> 3)) - 1);
    int base = mv_class == 0 ? 0 : (2 << (mv_class + 2));
    int offset = z - base;
    int d = offset >> 3;
    int fr = (offset >> 1) & 3;
    int hp = offset & 1;
    code_bin(t.nmv_sign + comp_idx * 3, sign);
    code_sym(t.nmv_classes + comp_idx * 12, mv_class, 11);
    if (mv_class == 0) {
      code_sym(t.nmv_class0 + comp_idx * 3, d, 2);
    } else {
      int n = mv_class;  // + CLASS0_BITS - 1 == mv_class
      for (int i = 0; i < n; ++i)
        code_bin(t.nmv_bits + (comp_idx * 10 + i) * 3, (d >> i) & 1);
    }
    if (precision > 0) {
      int32_t* cdf = mv_class == 0 ? t.nmv_class0_fp + (comp_idx * 2 + d) * 5
                                   : t.nmv_fp + comp_idx * 5;
      code_sym(cdf, fr, 4);
    }
    if (precision > 1) {
      int32_t* cdf = mv_class == 0 ? t.nmv_class0_hp + comp_idx * 3
                                   : t.nmv_hp + comp_idx * 3;
      code_bin(cdf, hp);
    }
  }

  // (avail, intra, comp, bwd-single) of one coded neighbor mi
  void nbr_state(int r, int c, bool* avail, bool* intra, bool* comp,
                 bool* bwd) const {
    *avail = *intra = *comp = *bwd = false;
    if (r < 0 || c < 0) return;
    size_t p = static_cast<size_t>(r) * mi_cols + c;
    if (!mi_valid[p]) return;
    *avail = true;
    if (!mi_inter[p]) { *intra = true; return; }
    *comp = mi_ref2[p] > 0;
    *bwd = !*comp && mi_ref[p] >= 5;
  }

  int comp_inter_ctx(int r4, int c4) const {
    bool aa, ai, ac, ab, la, li, lc, lb;
    nbr_state(r4 - 1, c4, &aa, &ai, &ac, &ab);
    nbr_state(r4, c4 - 1, &la, &li, &lc, &lb);
    if (aa && la) {
      if (!ac && !lc) return (ab ? 1 : 0) ^ (lb ? 1 : 0);
      if (!ac) return 2 + ((ab || ai) ? 1 : 0);
      if (!lc) return 2 + ((lb || li) ? 1 : 0);
      return 4;
    }
    if (la) return lc ? 3 : (lb ? 1 : 0);
    if (aa) return ac ? 3 : (ab ? 1 : 0);
    return 1;
  }

  int comp_ref_type_ctx(int r4, int c4) const {
    bool aa, ai, ac, ab, la, li, lc, lb;
    nbr_state(r4 - 1, c4, &aa, &ai, &ac, &ab);
    nbr_state(r4, c4 - 1, &la, &li, &lc, &lb);
    if (aa && la) {
      if (ai && li) return 2;
      if (li) return ac ? 1 : 2;
      if (ai) return lc ? 1 : 2;
      if (!ac && !lc) return 1 + 2 * ((ab == lb) ? 1 : 0);
      if (!ac || !lc) return 1;
      return 0;
    }
    if (la) return (li || !lc) ? 2 : 0;
    if (aa) return (ai || !ac) ? 2 : 0;
    return 2;
  }

  static constexpr int COMP_MODE_CTX_MAP[3][5] = {
      {0, 1, 1, 1, 1}, {1, 2, 3, 4, 4}, {4, 4, 5, 6, 7}};

  void write_inter_block(int r4, int c4, int n4) {
    const int bs = n4 * 4;                  // luma pixels
    const int ny = bs * bs, nc = (bs / 2) * (bs / 2);
    int32_t buf_y[64 * 64], buf_u[32 * 32], buf_v[32 * 32];
    const int32_t *l0, *l1, *l2;
    if (lv_pack[0]) {
      // stitch the leaf's level grids from its packed cell tiles
      const int r8 = r4 >> 1, c8 = c4 >> 1, k = n4 >> 1;
      const int cbs = bs / 2;
      for (int cy = 0; cy < k; ++cy)
        for (int cx = 0; cx < k; ++cx) {
          const long cell = static_cast<long>(r8 + cy) * nb8w + c8 + cx;
          const int16_t* tp = lv_pack[0] + cell * 64;
          for (int yy = 0; yy < 8; ++yy) {
            int32_t* dst = buf_y + (cy * 8 + yy) * bs + cx * 8;
            for (int xx = 0; xx < 8; ++xx) dst[xx] = tp[yy * 8 + xx];
          }
          const int16_t* up = lv_pack[1] + cell * 16;
          const int16_t* vp = lv_pack[2] + cell * 16;
          for (int yy = 0; yy < 4; ++yy) {
            int32_t* du = buf_u + (cy * 4 + yy) * cbs + cx * 4;
            int32_t* dv = buf_v + (cy * 4 + yy) * cbs + cx * 4;
            for (int xx = 0; xx < 4; ++xx) {
              du[xx] = up[yy * 4 + xx];
              dv[xx] = vp[yy * 4 + xx];
            }
          }
        }
      l0 = buf_y;
      l1 = buf_u;
      l2 = buf_v;
    } else {
      const int size_idx =
          n4 == 2 ? 0 : (n4 == 4 ? 1 : (n4 == 8 ? 2 : 3));
      const int gb_w = (nb8w * 8) / bs;     // per-size grid width
      int br = (r4 * 4) / bs, bc = (c4 * 4) / bs;
      l0 = lv_inter[size_idx][0] + (static_cast<long>(br) * gb_w + bc) * ny;
      l1 = lv_inter[size_idx][1] + (static_cast<long>(br) * gb_w + bc) * nc;
      l2 = lv_inter[size_idx][2] + (static_cast<long>(br) * gb_w + bc) * nc;
    }
    bool skip = true;
    for (int i = 0; i < ny && skip; ++i) skip = l0[i] == 0;
    for (int i = 0; i < nc && skip; ++i) skip = l1[i] == 0 && l2[i] == 0;
    const int32_t* mvp = mvs + (static_cast<long>(r4 >> 1) * nb8w +
                                (c4 >> 1)) * 2;
    int mv8_r = mvp[0], mv8_c = mvp[1];  // 1/8-pel units

    // skip coeff flag
    int above = r4 > 0 ? skips[(r4 - 1) * mi_cols + c4] : 0;
    int left = c4 > 0 ? skips[r4 * mi_cols + c4 - 1] : 0;
    code_bin(t.skip + (above + left) * 3, skip ? 1 : 0);
    write_cdef_idx(r4, c4, skip);
    write_delta_q(r4, c4, n4, skip);

    // is_inter (ctx from coded top/left intra-vs-inter state)
    bool ha = r4 > 0 && mi_valid[(r4 - 1) * mi_cols + c4];
    bool hl = c4 > 0 && mi_valid[r4 * mi_cols + c4 - 1];
    bool ai = ha && !mi_inter[(r4 - 1) * mi_cols + c4];
    bool li = hl && !mi_inter[r4 * mi_cols + c4 - 1];
    int ctx;
    if (ha && hl) ctx = (ai && li) ? 3 : (ai || li) ? 1 : 0;
    else if (ha) ctx = 2 * ai;
    else if (hl) ctx = 2 * li;
    else ctx = 0;
    code_bin(t.intra_inter + ctx * 3, 1);

    // reference coding (mirror of syntax code_comp_inter /
    // code_comp_refs / code_single_ref; ref WriteRefFrames)
    const int ref_cell = ref_map
        ? static_cast<int>(ref_map[(r4 >> 1) * nb8w + (c4 >> 1)])
        : LAST_FRAME;
    const bool is_cmp = ref_select && ref_cell == 0;
    if (ref_select)
      code_bin(t.comp_inter + comp_inter_ctx(r4, c4) * 3, is_cmp ? 1 : 0);
    int counts[8] = {0};
    for (int n = 0; n < 2; ++n) {
      int nr = n ? r4 : r4 - 1, ncl = n ? c4 - 1 : c4;
      bool av = n ? hl : ha;
      if (!av) continue;
      size_t p = static_cast<size_t>(nr) * mi_cols + ncl;
      if (!mi_inter[p]) continue;
      ++counts[static_cast<int>(mi_ref[p])];
      if (mi_ref2[p] > 0) ++counts[static_cast<int>(mi_ref2[p])];
    }
    auto rctx = [](int a, int b) { return a == b ? 1 : (a < b ? 0 : 2); };
    int ref = ref_cell, ref2 = -1, mode = NEWMV;
    int mv8b_r = 0, mv8b_c = 0;
    if (is_cmp) {
      ref = comp_fwd;
      ref2 = comp_bwd;
      code_bin(t.comp_ref_type + comp_ref_type_ctx(r4, c4) * 3, 1);
      int bit = ref == 3 || ref == 4;
      code_bin(t.comp_ref +
                   (rctx(counts[1] + counts[2],
                         counts[3] + counts[4]) * 3 + 0) * 3, bit);
      if (!bit)
        code_bin(t.comp_ref + (rctx(counts[1], counts[2]) * 3 + 1) * 3,
                 ref == 2);
      else
        code_bin(t.comp_ref + (rctx(counts[3], counts[4]) * 3 + 2) * 3,
                 ref == 4);
      int bb = ref2 == 7;
      code_bin(t.comp_bwdref +
                   (rctx(counts[5] + counts[6], counts[7]) * 2 + 0) * 3, bb);
      if (!bb)
        code_bin(t.comp_bwdref + (rctx(counts[5], counts[6]) * 2 + 1) * 3,
                 ref2 == 6);

      const int32_t* mvp2 = mvs2 + (static_cast<long>(r4 >> 1) * nb8w +
                                    (c4 >> 1)) * 2;
      mv8b_r = mvp2[0];
      mv8b_c = mvp2[1];
      StackResult res;
      find_mv_stack(r4, c4, n4, n4, &res, ref, ref2);
      auto lower = [](int v) {
        if (v & 1) v += v > 0 ? -1 : 1;
        return v;
      };
      int p0r = lower(res.stack[0].mv[0]), p0c = lower(res.stack[0].mv[1]);
      int p1r = lower(res.stack[0].mv2[0]), p1c = lower(res.stack[0].mv2[1]);
      int mctx = COMP_MODE_CTX_MAP[res.refmv_ctx() >> 1]
                                  [std::min(res.newmv_ctx(), 4)];
      if (mv8_r == p0r && mv8_c == p0c && mv8b_r == p1r && mv8b_c == p1c) {
        mode = 17;  // NEAREST_NEARESTMV
        code_sym(t.inter_comp_mode + mctx * 9, 0, 8);
      } else {
        mode = 24;  // NEW_NEWMV
        code_sym(t.inter_comp_mode + mctx * 9, 7, 8);
        if (res.num_found > 1)
          code_bin(t.drl + res.drl_ctx(0) * 3, 0);
        int dr = mv8_r - p0r, dc = mv8_c - p0c;
        int j = (dr ? 2 : 0) | (dc ? 1 : 0);
        code_sym(t.nmv_joints, j, 4);
        if (j & 2) encode_mv_component(dr, 0, 1);
        if (j & 1) encode_mv_component(dc, 1, 1);
        dr = mv8b_r - p1r;
        dc = mv8b_c - p1c;
        j = (dr ? 2 : 0) | (dc ? 1 : 0);
        code_sym(t.nmv_joints, j, 4);
        if (j & 2) encode_mv_component(dr, 0, 1);
        if (j & 1) encode_mv_component(dc, 1, 1);
      }
    } else {
      int fwd = counts[1] + counts[2] + counts[3] + counts[4];
      int bwd = counts[5] + counts[6] + counts[7];
      int bit0 = ref >= 5;
      code_bin(t.single_ref + (rctx(fwd, bwd) * 6 + 0) * 3, bit0);
      if (bit0) {
        int bit1 = ref == 7;
        code_bin(t.single_ref +
                     (rctx(counts[5] + counts[6], counts[7]) * 6 + 1) * 3,
                 bit1);
        if (!bit1)
          code_bin(t.single_ref + (rctx(counts[5], counts[6]) * 6 + 5) * 3,
                   ref == 6);
      } else {
        int bit2 = ref == 3 || ref == 4;
        code_bin(
            t.single_ref +
                (rctx(counts[1] + counts[2],
                      counts[3] + counts[4]) * 6 + 2) * 3,
            bit2);
        if (bit2)
          code_bin(t.single_ref + (rctx(counts[3], counts[4]) * 6 + 4) * 3,
                   ref != 3);
        else
          code_bin(t.single_ref + (rctx(counts[1], counts[2]) * 6 + 3) * 3,
                   ref != 1);
      }

      // mode + drl + mv: NEARESTMV when the MV equals stack[0] and
      // GLOBALMV when it equals the frame's global translation (both
      // skip MV coding); NEWMV otherwise -- mirrors pipeline/tile.py
      int gmr = 0, gmc = 0, gact = 0;
      if (gm_type && gm_type[ref - 1]) {
        gact = 1;
        gmr = gm_vec[(ref - 1) * 2];
        gmc = gm_vec[(ref - 1) * 2 + 1];
      }
      StackResult res;
      find_mv_stack(r4, c4, n4, n4, &res, ref, -1, gmr, gmc);
      // predictor: stack[0], lowered to 1/4-pel precision (allow_hp=0)
      int pr_r = res.stack[0].mv[0], pr_c = res.stack[0].mv[1];
      if (pr_r & 1) pr_r += pr_r > 0 ? -1 : 1;
      if (pr_c & 1) pr_c += pr_c > 0 ? -1 : 1;
      int p1r = res.stack[1].mv[0], p1c = res.stack[1].mv[1];
      if (p1r & 1) p1r += p1r > 0 ? -1 : 1;
      if (p1c & 1) p1c += p1c > 0 ? -1 : 1;
      if (mv8_r == pr_r && mv8_c == pr_c) {
        mode = NEARESTMV;
        code_bin(t.newmv + res.newmv_ctx() * 3, 1);
        code_bin(t.zeromv + res.zeromv_ctx() * 3, 1);
        code_bin(t.refmv + res.refmv_ctx() * 3, 0);
      } else if (gact && mv8_r == gmr && mv8_c == gmc) {
        mode = GLOBALMV;
        code_bin(t.newmv + res.newmv_ctx() * 3, 1);
        code_bin(t.zeromv + res.zeromv_ctx() * 3, 0);
      } else if (res.num_found >= 2 && mv8_r == p1r && mv8_c == p1c) {
        mode = NEARMV;
        code_bin(t.newmv + res.newmv_ctx() * 3, 1);
        code_bin(t.zeromv + res.zeromv_ctx() * 3, 1);
        code_bin(t.refmv + res.refmv_ctx() * 3, 1);
        // drl for NEARMV idx 0 (pipeline code_drl_idx NEARMV gate)
        if (res.num_found > 2) code_bin(t.drl + res.drl_ctx(1) * 3, 0);
      } else {
        mode = NEWMV;
        code_bin(t.newmv + res.newmv_ctx() * 3, 0);
        if (res.num_found > 1) {
          code_bin(t.drl + res.drl_ctx(0) * 3, 0);  // drl_idx == 0
        }
        int dr = mv8_r - pr_r, dc = mv8_c - pr_c;
        int j = (dr ? 2 : 0) | (dc ? 1 : 0);
        code_sym(t.nmv_joints, j, 4);
        if (j & 2) encode_mv_component(dr, 0, 1);
        if (j & 1) encode_mv_component(dc, 1, 1);
      }
    }

    // state update
    for (int i = 0; i < n4; ++i)
      for (int jj = 0; jj < n4; ++jj) {
        size_t p = static_cast<size_t>(r4 + i) * mi_cols + c4 + jj;
        skips[p] = skip ? 1 : 0;
        y_modes[p] = 0;
        mi_valid[p] = 1;
        mi_inter[p] = 1;
        mi_ref[p] = static_cast<int8_t>(ref);
        mi_ref2[p] = static_cast<int8_t>(ref2);
        mi_mode[p] = static_cast<uint8_t>(mode);
        mi_mv[p * 2] = static_cast<int16_t>(mv8_r);
        mi_mv[p * 2 + 1] = static_cast<int16_t>(mv8_c);
        mi_mv2[p * 2] = static_cast<int16_t>(mv8b_r);
        mi_mv2[p * 2 + 1] = static_cast<int16_t>(mv8b_c);
        mi_w4[p] = static_cast<uint8_t>(n4);
        mi_h4[p] = static_cast<uint8_t>(n4);
      }
    for (int i = 0; i < n4; ++i) {
      part_above[c4 + i] = static_cast<uint8_t>(32 - n4);
      part_left[r4 + i] = static_cast<uint8_t>(32 - n4);
    }

    // residuals (inter tx set DCT_IDTX: 2 syms, eset 3, DCT symbol = 1)
    const int32_t* lvs[3] = {l0, l1, l2};
    for (int plane = 0; plane < 3; ++plane) {
      int pr = plane ? r4 >> 1 : r4;
      int pc = plane ? c4 >> 1 : c4;
      int w4 = plane ? n4 >> 1 : n4;
      if (skip) {
        set_txb(plane, pr, pc, w4, w4, 0);
        continue;
      }
      int sctx, dctx;
      txb_ctx(plane, pr, pc, w4, w4, &sctx, &dctx);
      int pbs = plane ? bs / 2 : bs;
      // txs_ctx for square tx: log2(dim/4) (tx_size_ctx, syntax.py)
      int txs_ctx = pbs == 4 ? 0 : (pbs == 8 ? 1 : (pbs == 16 ? 2 : 3));
      const int32_t* lvp = lvs[plane];
      int cw = pbs;
      bool ttype_flag = plane == 0;
      int32_t tmp64[1024];
      if (pbs == 64) {
        // TX_64X64 codes only the top-left 32x32 adjusted region (spec
        // Adjusted_Tx_Size); tx type is DCT-only at dim 64 (no symbol)
        for (int rr = 0; rr < 32; ++rr)
          for (int cc2 = 0; cc2 < 32; ++cc2)
            tmp64[rr * 32 + cc2] = lvp[rr * 64 + cc2];
        lvp = tmp64;
        cw = 32;
        txs_ctx = 4;
        ttype_flag = false;
      }
      // luma tx type from the per-cell search map (0 = DCT, 9 = IDTX);
      // chroma inherits it for the inverse but its syntax stays class-2D
      int ttx = (plane == 0 && txty_map)
                    ? txty_map[static_cast<size_t>(r4 >> 1) * nb8w +
                               (c4 >> 1)]
                    : 0;
      int cul = write_coeffs_inter(lvp, cw, cw, txs_ctx,
                                   plane ? 1 : 0, sctx, dctx, ttype_flag,
                                   ttx);
      set_txb(plane, pr, pc, w4, w4, cul);
    }
  }

  // inter tx-type branch wrapper around write_coeffs
  int write_coeffs_inter(const int32_t* lv, int w, int h, int txs_ctx,
                         int plane_type, int sctx, int dctx,
                         bool tx_type_flag, int tx_type) {
    // identical to write_coeffs except the tx-type symbol source
    return write_coeffs_impl(lv, w, h, txs_ctx, plane_type, tx_type, sctx,
                             dctx, tx_type_flag, 0, true);
  }

  void partition(int r4, int c4, int n4) {
    if (r4 >= mi_rows || c4 >= mi_cols) return;
    bool leaf = n4 == 2;
    if (!leaf && inter_frame && n4 <= 16 &&
        size_map[static_cast<size_t>(r4 >> 1) * nb8w + (c4 >> 1)] == n4 * 4)
      leaf = true;
    if (!leaf && !inter_frame && n4 == 4 && isize_map &&
        isize_map[static_cast<size_t>(r4 >> 1) * nbw + (c4 >> 1)] == 16)
      leaf = true;
    if (leaf) {
      write_partition(r4, c4, n4, PARTITION_NONE);
      if (inter_frame) write_inter_block(r4, c4, n4);
      else write_block(r4, c4, n4);
      return;
    }
    write_partition(r4, c4, n4, PARTITION_SPLIT);
    int half = n4 >> 1;
    partition(r4, c4, half);
    partition(r4, c4 + half, half);
    partition(r4 + half, c4, half);
    partition(r4 + half, c4 + half, half);
  }

  long encode(const uint8_t* m, const int32_t* y, const int32_t* u,
              const int32_t* v, int bh, int bw, uint8_t* out, long cap) {
    modes = m;
    ly = y;
    lu = u;
    lvv = v;
    nbw = bw;
    (void)bh;
    for (int r4 = 0; r4 < mi_rows; r4 += 16)
      for (int c4 = 0; c4 < mi_cols; c4 += 16) {
        cdef_done = false;
        partition(r4, c4, 16);
      }
    return enc.done(out, cap);
  }
};

const int TileWriter::INTRA_MODE_CTX[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};

}  // namespace

extern "C" {

long svt_tile_blob_size() { return total_table_size(); }

long svt_encode_tile(int mi_rows, int mi_cols, int qindex, int reduced_tx_set,
                     const int32_t* cdf_blob, const uint8_t* modes,
                     const int32_t* ly, const int32_t* lu, const int32_t* lv,
                     int nbh, int nbw, uint8_t* out, long out_cap,
                     const uint8_t* cdef_idx, int cdef_bits,
                     const uint8_t* angles, const uint8_t* uv_modes,
                     const uint8_t* cfl, const uint8_t* sizes,
                     const int32_t* l16y, const int32_t* l16u,
                     const int32_t* l16v) {
  TileWriter tw;
  tw.init(mi_rows, mi_cols, qindex, reduced_tx_set, cdf_blob);
  tw.cdef_idx = cdef_idx;
  tw.cdef_bits = cdef_bits;
  tw.angles_map = angles;
  tw.uv_map = uv_modes;
  tw.cfl_map = cfl;
  tw.isize_map = sizes;
  tw.l16y = l16y;
  tw.l16u = l16u;
  tw.l16v = l16v;
  tw.nsb_w = (mi_cols + 15) / 16;
  return tw.encode(modes, ly, lu, lv, nbh, nbw, out, out_cap);
}

long svt_encode_tile_inter(int mi_rows, int mi_cols, int qindex,
                           int reduced_tx_set, const int32_t* cdf_blob,
                           const uint8_t* sizes, const int32_t* mvs,
                           const int32_t* const* levels9, int nb8h,
                           int nb8w, uint8_t* out, long out_cap,
                           const uint8_t* cdef_idx, int cdef_bits,
                           const uint8_t* refs, const uint8_t* sign_bias,
                           const int32_t* mvs2, int comp_fwd,
                           int comp_bwd, const uint8_t* txty,
                           const uint8_t* gm_type, const int32_t* gm_vec,
                           const int16_t* pack_y, const int16_t* pack_u,
                           const int16_t* pack_v, const int32_t* qmap,
                           int dq_res) {
  TileWriter tw;
  tw.init(mi_rows, mi_cols, qindex, reduced_tx_set, cdf_blob);
  tw.inter_frame = true;
  tw.size_map = sizes;
  tw.mvs = mvs;
  tw.ref_map = refs;
  tw.mvs2 = mvs2;
  tw.txty_map = txty;
  tw.gm_type = gm_type;
  tw.gm_vec = gm_vec;
  tw.ref_select = mvs2 != nullptr;
  tw.comp_fwd = comp_fwd;
  tw.comp_bwd = comp_bwd;
  tw.qmap = qmap;
  tw.dq_res = dq_res;
  tw.cur_q = qindex;
  if (sign_bias)
    for (int i = 0; i < 8; ++i) tw.sign_bias[i] = sign_bias[i];
  if (pack_y) {
    tw.lv_pack[0] = pack_y;
    tw.lv_pack[1] = pack_u;
    tw.lv_pack[2] = pack_v;
  } else {
    for (int s = 0; s < 4; ++s)
      for (int p = 0; p < 3; ++p) tw.lv_inter[s][p] = levels9[s * 3 + p];
  }
  tw.nb8w = nb8w;
  tw.cdef_idx = cdef_idx;
  tw.cdef_bits = cdef_bits;
  tw.nsb_w = (mi_cols + 15) / 16;
  (void)nb8h;
  for (int r4 = 0; r4 < mi_rows; r4 += 16)
    for (int c4 = 0; c4 < mi_cols; c4 += 16) {
      tw.cdef_done = false;
      tw.dq_done = false;
      tw.partition(r4, c4, 16);
    }
  return tw.enc.done(out, out_cap);
}

}  // extern "C"
