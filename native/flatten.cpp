// Native scene flattener: Fig node arrays -> packed quad tape.
//
// C++ twin of the hot host path (figdraw_tpu/render.py walk +
// figdraw_tpu/tape.py quad encoding), the TPU-native counterpart of the
// reference's per-frame tree walk and GL vertex-stream packing
// (/root/reference/src/figdraw/figrender.nim:1756-1839 +
// opengl/glcontext.nim:908-1559). The Python walk costs ~50 ms/frame on the
// 300-box scene; this walk over the same data as a NumPy structured array
// (figdraw_tpu/nodesarray.py FIG_DTYPE) runs in well under a millisecond.
//
// Covered node kinds: frame, rectangle (fills/strokes/drop+inset shadows,
// circular+elliptical corners, gradients), backdrop blur, transform,
// scrollbar, image/MSDF/MTSDF (atlas lookup + mip select), and drawables
// (lines/circles/rects/ellipses, adaptive+fixed bezier/arc quadratic spans,
// caps/joins, per-node AA override — figrender.nim:908-1667), plus clip
// masks, rect-mask fast path, rotation, and text (GlyphRow/TextRect rows:
// glyph atlas quads, selection bands, decorations — see render_text_node below;
// nodesarray.py NATIVE_KINDS gates dispatch).
//
// Build: g++ -O2 -shared -fPIC -o libfigdraw_flatten.so flatten.cpp

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <algorithm>
#include <array>
#include <vector>

namespace {

// ---- layout mirrors figdraw_tpu/ops/layout.py -------------------------------
constexpr int QF_WIDTH = 68;
constexpr int QI_WIDTH = 2;
constexpr int QF_INV_A = 0, QF_ORG_X = 4, QF_BBOX = 6, QF_UV = 10;
constexpr int QF_COLOR0 = 16, QF_MID = 32, QF_STOP = 36;
constexpr int QF_PARAMS = 40, QF_RADII = 44, QF_FACTORS = 48;
constexpr int QF_AA = 50, QF_SUBPIX = 51, QF_RECT = 52;

// ---- FIG_DTYPE mirrors figdraw_tpu/nodesarray.py ----------------------------
#pragma pack(push, 1)
struct PackedFill {
  uint8_t kind, axis, midpos, pad;
  uint8_t c0[4], c1[4], c2[4];
};
struct PackedShadow {
  uint8_t style, pad[3];
  float blur, spread, x, y;
  PackedFill fill;
};
struct Fig {
  uint8_t kind;
  int8_t zlevel;
  uint16_t flags;
  int16_t parent;
  int16_t child_count;
  float box[4];
  float rotation;
  PackedFill fill;
  uint16_t corners[4];
  uint16_t corners_y[4];
  float stroke_weight;
  PackedFill stroke_fill;
  PackedShadow shadows[4];
  float blur;
  float tx, ty;
  uint8_t use_matrix, pad2[3];
  float matrix[6];
  int64_t image_id;
  float px_range, sd_threshold, msdf_stroke;
  PackedFill image_fill;
  int32_t ops_start, ops_count;
  float draw_weight;
  uint8_t draw_cap, draw_join;
  uint16_t draw_steps;
  float draw_aa;
  PackedFill draw_stroke_fill;
  int32_t glyphs_start, glyphs_count;
  int32_t trects_start, trects_count;
};

struct GlyphRow {  // nodesarray.py GLYPH_DTYPE
  int64_t font_id;
  int32_t glyph_id;
  PackedFill fill;  // span fill — glyph quads take gradientColors vertex
                    // mapping like every quad (figrender.nim:494)
  double x, y, img_ox, img_oy;
};

struct TextRect {  // nodesarray.py TRECT_DTYPE
  double x, y, w, h;
  PackedFill fill;
};
#pragma pack(pop)

#pragma pack(push, 1)
struct DrawOp {
  uint8_t kind, pad[3];
  int32_t p_start, p_count;
  uint16_t steps, pad2;
  float data[8];
};
#pragma pack(pop)

constexpr uint8_t NK_TEXT = 1, NK_RECT = 2, NK_DRAWABLE = 3, NK_IMAGE = 5, NK_MSDF = 6,
                  NK_MTSDF = 7, NK_BACKDROP = 8, NK_TRANSFORM = 9;
constexpr uint8_t DK_LINE = 0, DK_CIRCLE = 1, DK_RECT = 2, DK_BEZIER = 3,
                  DK_ARC = 4, DK_ELLIPSE = 5;
constexpr uint8_t CAP_AUTO = 0, CAP_ROUND = 1, CAP_BUTT = 2, CAP_SQUARE = 3;
constexpr uint8_t JOIN_AUTO = 0, JOIN_ROUND = 1, JOIN_BEVEL = 2, JOIN_MITER = 3;
constexpr uint16_t NF_CLIP = 1 << 0, NF_DISABLE = 1 << 1, NF_INVERT_Y = 1 << 5,
                   NF_RECTMASK = 1 << 6, NF_ELLIPTICAL = 1 << 7;

constexpr int MODE_CLIP_AA = 3, MODE_DROP = 7, MODE_INSET = 9, MODE_ANNULAR_AA = 12,
              MODE_ATLAS = 0, MODE_MSDF = 13, MODE_MTSDF = 14, MODE_MSDF_ANN = 15,
              MODE_MTSDF_ANN = 16, MODE_BACKDROP = 17, MODE_BEZ_ROUND = 18,
              MODE_BEZ_BUTT = 19, MODE_BEZ_SQUARE = 20;

// figrender.nim:1162-1166 adaptive-curve tuning
constexpr double ADAPTIVE_TOL_PX = 0.5;
constexpr double SDF_PADDING_PX = 2.0;
constexpr int MAX_ADAPTIVE_STEPS = 192;  // max(48*4, 64)
constexpr int MAX_ADAPTIVE_DEPTH = 8;
constexpr int FRAME_TARGET = -1;

struct Mat3 {  // row-major 2D affine; double to match Python float64 math
  double a = 1, b = 0, tx = 0, c = 0, d = 1, ty = 0;
};

inline Mat3 matmul(const Mat3& m, const Mat3& o) {
  Mat3 r;
  r.a = m.a * o.a + m.b * o.c;
  r.b = m.a * o.b + m.b * o.d;
  r.tx = m.a * o.tx + m.b * o.ty + m.tx;
  r.c = m.c * o.a + m.d * o.c;
  r.d = m.c * o.b + m.d * o.d;
  r.ty = m.c * o.tx + m.d * o.ty + m.ty;
  return r;
}
inline Mat3 mat_translate(double x, double y) { Mat3 m; m.tx = x; m.ty = y; return m; }
inline Mat3 mat_rotate(double ang) {
  // +angle = counter-clockwise on the y-down screen (see geometry.py Mat3)
  Mat3 m; double co = std::cos(ang), si = std::sin(ang);
  m.a = co; m.b = si; m.c = -si; m.d = co; return m;
}
inline Mat3 mat_scale(double sx, double sy) { Mat3 m; m.a = sx; m.d = sy; return m; }
inline Mat3 mat_inverse(const Mat3& m) {
  double det = m.a * m.d - m.b * m.c;
  if (std::fabs(det) <= 1e-12) return Mat3();
  double id = 1.0 / det;
  Mat3 r;
  r.a = m.d * id; r.b = -m.b * id; r.c = -m.c * id; r.d = m.a * id;
  r.tx = -(r.a * m.tx + r.b * m.ty);
  r.ty = -(r.c * m.tx + r.d * m.ty);
  return r;
}

inline double round_away(double v) { return std::floor(v + 0.5); }  // v >= 0 here

struct Color4 { float r, g, b, a; };

inline Color4 norm_color(const uint8_t c[4]) {
  return {c[0] / 255.0f, c[1] / 255.0f, c[2] / 255.0f, c[3] / 255.0f};
}

// sampleColor with per-channel round-half-away at u8 precision
// (figbackend.nim:129-153)
inline void lerp_u8(const uint8_t a[4], const uint8_t b[4], double t, uint8_t out[4]) {
  double tt = t < 0 ? 0 : (t > 1 ? 1 : t);
  for (int i = 0; i < 4; i++) {
    double v = a[i] * (1.0 - tt) + b[i] * tt;
    int iv = (int)(v + 0.5f);
    out[i] = (uint8_t)(iv < 0 ? 0 : (iv > 255 ? 255 : iv));
  }
}

inline void fill_sample(const PackedFill& f, double t, uint8_t out[4]) {
  if (f.kind == 0) { std::memcpy(out, f.c0, 4); return; }
  if (f.kind == 1) { lerp_u8(f.c0, f.c1, t, out); return; }
  double tt = t < 0 ? 0 : (t > 1 ? 1 : t);
  double mid = f.midpos / 255.0;
  mid = mid < 0.01 ? 0.01 : (mid > 0.99 ? 0.99 : mid);
  if (tt <= mid) lerp_u8(f.c0, f.c1, tt / mid, out);
  else lerp_u8(f.c1, f.c2, (tt - mid) / (1.0 - mid), out);
}

inline int fill_alpha_max(const PackedFill& f) {
  if (f.kind == 0) return f.c0[3];
  if (f.kind == 1) return f.c0[3] > f.c1[3] ? f.c0[3] : f.c1[3];
  int m = f.c0[3] > f.c1[3] ? f.c0[3] : f.c1[3];
  return m > f.c2[3] ? m : f.c2[3];
}

// gradientColors vertex order 0=BL 1=BR 2=TR 3=TL (figbackend.nim:161-183)
inline void gradient_colors(const PackedFill& f, uint8_t out[4][4]) {
  double ts[4];
  int axis = (f.kind == 0) ? 0 : f.axis;
  switch (axis) {
    case 0: ts[0] = 0; ts[1] = 1; ts[2] = 1; ts[3] = 0; break;           // X
    case 1: ts[0] = 1; ts[1] = 1; ts[2] = 0; ts[3] = 0; break;           // Y
    case 2: ts[0] = 0.5; ts[1] = 1; ts[2] = 0.5; ts[3] = 0; break;       // TLBR
    default: ts[0] = 0; ts[1] = 0.5; ts[2] = 1; ts[3] = 0.5; break;      // BLTR
  }
  for (int i = 0; i < 4; i++) fill_sample(f, ts[i], out[i]);
}

// corner-radius packing (glcontext.nim:743-817); radii order TL,TR,BL,BR in
// x/y arrays, output (TR, BR, TL, BL)
struct PackedRadii { double v[4]; bool elliptical; };

inline double clamp_radius(double r, double maxr) {
  if (r <= 0.0) return 0.0;
  double v = r < maxr ? r : maxr;
  if (v < 1.0) v = 1.0;
  return round_away(v);
}

PackedRadii pack_radii(const double rx[4], const double ry[4], double hx, double hy) {
  PackedRadii out{};
  bool circular = true;
  for (int i = 0; i < 4; i++) circular = circular && (rx[i] == ry[i]);
  const int TL = 0, TR = 1, BL = 2, BR = 3;
  if (circular) {
    double maxr = hx < hy ? hx : hy;
    out.v[0] = clamp_radius(rx[TR], maxr);
    out.v[1] = clamp_radius(rx[BR], maxr);
    out.v[2] = clamp_radius(rx[TL], maxr);
    out.v[3] = clamp_radius(rx[BL], maxr);
    out.elliptical = false;
    return out;
  }
  double circle_max = hx < hy ? hx : hy;
  auto enc = [&](int i) -> double {
    bool same_axes = rx[i] == ry[i];
    double circle_r = clamp_radius(rx[i], circle_max);
    if (same_axes) return -(circle_r + 1.0);
    double cx = clamp_radius(rx[i], hx);
    double cy = clamp_radius(ry[i], hy);
    if (cx == cy) return -(cx + 1.0);
    double nx = cx / (hx > 1e-6 ? hx : 1e-6);
    double ny = cy / (hy > 1e-6 ? hy : 1e-6);
    nx = nx < 0 ? 0 : (nx > 1 ? 1 : nx);
    ny = ny < 0 ? 0 : (ny > 1 ? 1 : ny);
    return round_away(nx * 4095.0) + round_away(ny * 4095.0) * 4096.0;
  };
  out.v[0] = enc(TR);
  out.v[1] = enc(BR);
  out.v[2] = enc(TL);
  out.v[3] = enc(BL);
  out.elliptical = true;
  return out;
}

struct RectMask {
  bool fast;
  double params[4], radii[4], matx[4], maty[4];
};

struct Item {
  int32_t kind;  // 0 draw, 1 blur, 2 clear_mask
  int32_t target;
  int32_t start, end;
  float radius;
};

struct AtlasEntry {
  int64_t id;
  int32_t level;
  float x, y, w, h;  // normalized uv rect
};

struct Ctx {
  double ui_scale = 1.0, aa = 1.2;
  double white_u = 0.0, white_v = 0.0;
  const DrawOp* ops = nullptr;  // drawable geometry for the current layer
  const float* points = nullptr;
  const GlyphRow* glyphs = nullptr;  // text geometry for the current layer
  const TextRect* trects = nullptr;
  bool text_lcd = false, text_subpixel = false, text_variants = false;
  double subpixel_shift = 0.0;  // active per-quad shift (tape.py semantics)
  std::vector<int64_t> glyph_off_keys;  // sorted; parallel to glyph_offs
  std::vector<float> glyph_offs;        // (n, 2) raster origin offsets

  const float* find_glyph_offset(int64_t key) const {
    size_t lo = 0, hi = glyph_off_keys.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (glyph_off_keys[mid] < key) lo = mid + 1;
      else hi = mid;
    }
    if (lo < glyph_off_keys.size() && glyph_off_keys[lo] == key)
      return &glyph_offs[lo * 2];
    return nullptr;
  }
  std::vector<AtlasEntry> atlas_entries;  // sorted by (id, level)
  float atlas_size = 1.0f;

  const AtlasEntry* find_entry(int64_t id, int32_t level) const {
    size_t lo = 0, hi = atlas_entries.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      const AtlasEntry& e = atlas_entries[mid];
      if (e.id < id || (e.id == id && e.level < level)) lo = mid + 1;
      else hi = mid;
    }
    if (lo < atlas_entries.size() && atlas_entries[lo].id == id &&
        atlas_entries[lo].level == level)
      return &atlas_entries[lo];
    return nullptr;
  }
  Mat3 mat;
  std::vector<Mat3> mats;
  std::vector<float> fields;
  std::vector<int32_t> modes;
  int count = 0;
  std::vector<Item> items;
  // persistent worker contexts for the parallel layer walk (created lazily,
  // freed with the owner; raw pointers keep Ctx self-referential)
  std::vector<struct Ctx*> workers;
  int mask_write = 0;
  int mask_count = 0;
  bool mask_begun = false;
  // per-plane clip SUPPORT (tape.py plane_support): union of the write
  // quads' stored screen bboxes since the plane's last clear. Quads reading
  // plane k clamp their bbox to it — bit-exact (contribution outside is
  // exactly 0), and spilling clipped content stops binning into tiles where
  // its mask is all-zero. Entry [k] is valid once begin_mask(k) ran this
  // walk; index 0 (all-pass) is never clamped.
  std::vector<std::array<float, 4>> plane_support;
  bool merged = false;  // items already run-merged (reset by any new walk)
  bool any_atlas = false, any_backdrop = false;
  std::vector<RectMask> rect_masks;
  // open run
  bool run_open = false;
  int run_target = 0, run_mask = 0, run_start = 0;

  double s(double v) const { return v * ui_scale; }

  void close_run() {
    if (run_open && run_start < count)
      items.push_back({0, run_target, run_start, count, 0.0f});
    run_open = false;
  }
  int ensure_run() {
    int tgt = mask_begun ? mask_write : FRAME_TARGET;
    int mrd = mask_begun ? mask_write - 1 : mask_write;
    if (!run_open || run_target != tgt || run_mask != mrd) {
      close_run();
      run_open = true;
      run_target = tgt;
      run_mask = mrd;
      run_start = count;
    }
    return mrd;
  }

  const RectMask* active_rect_mask() const {
    if (mask_begun) return nullptr;
    for (auto it = rect_masks.rbegin(); it != rect_masks.rend(); ++it)
      if (it->fast) return &*it;
    return nullptr;
  }

  float* alloc_quad(int mask_read, int packed_mode) {
    int base = packed_mode % 256;
    if (base >= 128) base -= 128;
    if (base == 0 || (base >= 13 && base <= 16)) any_atlas = true;
    if (base == 17) any_backdrop = true;
    size_t need = (size_t)(count + 1) * QF_WIDTH;
    if (fields.size() < need) fields.resize(need * 2, 0.0f);
    if (modes.size() < (size_t)(count + 1) * QI_WIDTH)
      modes.resize((size_t)(count + 1) * QI_WIDTH * 2, 0);
    float* f = &fields[(size_t)count * QF_WIDTH];
    std::memset(f, 0, QF_WIDTH * sizeof(float));
    modes[(size_t)count * QI_WIDTH + 0] = packed_mode;
    modes[(size_t)count * QI_WIDTH + 1] = mask_read;
    count++;
    return f;
  }
};

// ceil-snapped transformed quad corners, order BL BR TR TL
// (glcontext.nim:1036-1040,1498-1503)
inline void pos_quad(const Mat3& m, double x0, double y0, double x1, double y1,
                     double out[4][2]) {
  const double xs[4] = {x0, x1, x1, x0};
  const double ys[4] = {y1, y1, y0, y0};
  for (int i = 0; i < 4; i++) {
    out[i][0] = std::ceil(m.a * xs[i] + m.b * ys[i] + m.tx);
    out[i][1] = std::ceil(m.c * xs[i] + m.d * ys[i] + m.ty);
  }
}

// emit one quad record (tape.py _emit_quad)
void emit_quad(Ctx& ctx, const double pq[4][2], const double uv[4][2],
               const uint8_t colors[4][4], const double params[4],
               const double radii[4], const double factors[2], int packed_mode,
               const uint8_t* mid_color, const uint8_t* stop_color) {
  int mask_read = ctx.ensure_run();
  double ax = pq[2][0] - pq[3][0], ay = pq[2][1] - pq[3][1];
  double bx = pq[0][0] - pq[3][0], by = pq[0][1] - pq[3][1];
  double det = ax * by - ay * bx;
  if (std::fabs(det) <= 1e-12) return;
  float* f = ctx.alloc_quad(mask_read, packed_mode);
  double inv = 1.0 / det;
  f[QF_INV_A + 0] = by * inv;
  f[QF_INV_A + 1] = -bx * inv;
  f[QF_INV_A + 2] = -ay * inv;
  f[QF_INV_A + 3] = ax * inv;
  f[QF_ORG_X + 0] = pq[3][0];
  f[QF_ORG_X + 1] = pq[3][1];
  double mnx = pq[0][0], mny = pq[0][1], mxx = pq[0][0], mxy = pq[0][1];
  for (int i = 1; i < 4; i++) {
    mnx = std::fmin(mnx, pq[i][0]);
    mny = std::fmin(mny, pq[i][1]);
    mxx = std::fmax(mxx, pq[i][0]);
    mxy = std::fmax(mxy, pq[i][1]);
  }
  if (mask_read >= 1 && mask_read < (int)ctx.plane_support.size()) {
    // clip-support clamp (tape.py _emit_quad twin): outside the plane's
    // write-quad union this quad's contribution is exactly 0
    const std::array<float, 4>& s = ctx.plane_support[mask_read];
    mnx = std::fmax(mnx, (double)s[0]);
    mny = std::fmax(mny, (double)s[1]);
    mxx = std::fmin(mxx, (double)s[2]);
    mxy = std::fmin(mxy, (double)s[3]);
    if (mnx > mxx || mny > mxy) {
      // fully clipped away: the inert-row bbox (never binned)
      mnx = 2e9; mny = 2e9; mxx = -2e9; mxy = -2e9;
    }
  }
  f[QF_BBOX + 0] = mnx;
  f[QF_BBOX + 1] = mny;
  f[QF_BBOX + 2] = mxx;
  f[QF_BBOX + 3] = mxy;
  if (ctx.mask_begun) {
    std::array<float, 4>& s = ctx.plane_support[ctx.mask_write];
    s[0] = std::fmin(s[0], f[QF_BBOX + 0]);
    s[1] = std::fmin(s[1], f[QF_BBOX + 1]);
    s[2] = std::fmax(s[2], f[QF_BBOX + 2]);
    s[3] = std::fmax(s[3], f[QF_BBOX + 3]);
  }
  f[QF_UV + 0] = uv[3][0];
  f[QF_UV + 1] = uv[3][1];
  f[QF_UV + 2] = uv[2][0] - uv[3][0];
  f[QF_UV + 3] = uv[2][1] - uv[3][1];
  f[QF_UV + 4] = uv[0][0] - uv[3][0];
  f[QF_UV + 5] = uv[0][1] - uv[3][1];
  for (int v = 0; v < 4; v++)
    for (int c = 0; c < 4; c++) f[QF_COLOR0 + v * 4 + c] = colors[v][c] / 255.0f;
  if (mid_color)
    for (int c = 0; c < 4; c++) f[QF_MID + c] = mid_color[c] / 255.0f;
  if (stop_color)
    for (int c = 0; c < 4; c++) f[QF_STOP + c] = stop_color[c] / 255.0f;
  for (int i = 0; i < 4; i++) f[QF_PARAMS + i] = params[i];
  for (int i = 0; i < 4; i++) f[QF_RADII + i] = radii[i];
  f[QF_FACTORS + 0] = factors[0];
  f[QF_FACTORS + 1] = factors[1];
  f[QF_AA] = ctx.aa;
  f[QF_SUBPIX] = (float)ctx.subpixel_shift;
  const RectMask* rm = ctx.active_rect_mask();
  if (rm) {
    for (int i = 0; i < 4; i++) f[QF_RECT + i] = rm->params[i];
    for (int i = 0; i < 4; i++) f[QF_RECT + 4 + i] = rm->radii[i];
    for (int i = 0; i < 4; i++) f[QF_RECT + 8 + i] = rm->matx[i];
    for (int i = 0; i < 4; i++) f[QF_RECT + 12 + i] = rm->maty[i];
  } else {
    f[QF_RECT + 2] = -1.0f;
    f[QF_RECT + 3] = -1.0f;
  }
}

// drawRoundedRectSdf (tape.py / glcontext.nim:1449-1559)
void draw_rounded_rect(Ctx& ctx, double rx, double ry, double rw, double rh,
                       const PackedFill& fill, const double radx[4],
                       const double rady[4], int mode, double factor, double spread,
                       double ssx, double ssy) {
  if (rw <= 0 || rh <= 0) return;
  int fill_mode = 0;
  uint8_t colors[4][4];
  const uint8_t* midc = nullptr;
  const uint8_t* stopc = nullptr;
  double mid_pos = 0.5;
  bool lin3_path = fill.kind == 2 && (mode == 3 || mode == 11 || mode == 12);
  if (lin3_path) {
    static const int axis_to_mode[4] = {1, 2, 3, 4};
    fill_mode = axis_to_mode[fill.axis & 3];
    for (int v = 0; v < 4; v++) std::memcpy(colors[v], fill.c0, 4);
    midc = fill.c1;
    stopc = fill.c2;
    double mp = fill.midpos / 255.0;
    mid_pos = mp < 0.01 ? 0.01 : (mp > 0.99 ? 0.99 : mp);
  } else {
    gradient_colors(fill, colors);
  }

  double qhx = rw * 0.5, qhy = rh * 0.5;
  bool inset = mode == MODE_INSET;
  double rsx = (ssx > 0 && ssy > 0) ? ssx : rw;
  double rsy = (ssx > 0 && ssy > 0) ? ssy : rh;
  double shx = inset ? qhx : rsx * 0.5;
  double shy = inset ? qhy : rsy * 0.5;
  double params[4];
  if (inset) {
    params[0] = qhx; params[1] = qhy; params[2] = ssx; params[3] = ssy;
  } else {
    params[0] = qhx; params[1] = qhy; params[2] = shx; params[3] = shy;
  }
  PackedRadii pr = pack_radii(radx, rady, shx, shy);
  double factors[2];
  factors[0] = factor;
  factors[1] = fill_mode == 0 ? spread : mid_pos;

  double pq[4][2];
  pos_quad(ctx.mat, rx, ry, rx + rw, ry + rh, pq);
  static const double uv[4][2] = {{0, 1}, {1, 1}, {1, 0}, {0, 0}};
  int packed = mode + (pr.elliptical ? 128 : 0) + fill_mode * 256;
  emit_quad(ctx, pq, uv, colors, params, pr.v, factors, packed, midc, stopc);
}

// node corner radii, scaled (figrender.nim:549-571)
void node_corners(const Ctx& ctx, const Fig& n, double rx[4], double ry[4]) {
  bool ell = (n.flags & NF_ELLIPTICAL) != 0;
  for (int i = 0; i < 4; i++) {
    rx[i] = ctx.s((double)n.corners[i]);
    ry[i] = ell ? ctx.s((double)n.corners_y[i]) : rx[i];
  }
}

// drawUvRect path for atlas-sampling quads (tape.py _draw_uv_rect)
void draw_uv_rect(Ctx& ctx, double ax, double ay, double bx, double by,
                  double u0, double v0, double u1, double v1,
                  const uint8_t colors[4][4], int mode,
                  double f0, double f1, const double params[4]) {
  double pq[4][2];
  pos_quad(ctx.mat, ax, ay, bx, by, pq);
  double uv[4][2] = {{u0, v1}, {u1, v1}, {u1, v0}, {u0, v0}};
  double radii[4] = {0, 0, 0, 0};
  double factors[2] = {f0, f1};
  emit_quad(ctx, pq, uv, colors, params, radii, factors, mode, nullptr, nullptr);
}

void draw_image_node(Ctx& ctx, const Fig& n, double bx, double by, double bw,
                     double bh) {
  const AtlasEntry* e = ctx.find_entry(n.image_id, 0);
  if (!e) return;
  bool flip = (n.flags & NF_INVERT_Y) != 0;
  double drw = bw, drh = bh;
  if (!(drw > 0 && drh > 0)) {
    drw = e->w * ctx.atlas_size;
    drh = e->h * ctx.atlas_size;
  }
  // flatten-time TRILINEAR mip blend (tape.py draw_image, bit-identical:
  // per-quad constant LOD; the bracketing level+1 rides a second quad whose
  // vertex alpha carries the u8-quantized linear-in-scale fraction)
  double native_w = e->w * ctx.atlas_size;
  double native_h = e->h * ctx.atlas_size;
  const AtlasEntry* blend_e = nullptr;
  double blend_t = 0.0;
  // LOD from the MAX-axis minification (GL max-axis footprint), exactly
  // like tape.py: std::max(x, 1e-6) == Python's max(x, 1e-6) bit-for-bit
  if (n.kind == NK_IMAGE && drw > 0 && drh > 0 &&
      (native_w > drw || native_h > drh)) {
    int level = 0;
    double scale = std::max(native_w / std::max(drw, 1e-6),
                            native_h / std::max(drh, 1e-6));
    const AtlasEntry* next;
    while (scale >= 2.0 && (next = ctx.find_entry(n.image_id, level + 1))) {
      level++;
      scale *= 0.5;
      e = next;
    }
    double t = scale - 1.0;  // in [0, 1) relative to the chosen level
    next = ctx.find_entry(n.image_id, level + 1);
    if (t > 1.0 / 255.0 && next) {
      blend_e = next;
      blend_t = t;
    }
  }
  double u0 = e->x, v0 = e->y, u1 = e->x + e->w, v1 = e->y + e->h;
  if (flip) { double t = v0; v0 = v1; v1 = t; }

  uint8_t colors[4][4];
  uint8_t center[4];
  fill_sample(n.image_fill, 0.5, center);
  for (int i = 0; i < 4; i++) std::memcpy(colors[i], center, 4);

  if (n.kind == NK_IMAGE) {
    double params[4] = {0, 0, 0, 0};
    draw_uv_rect(ctx, bx, by, bx + drw, by + drh, u0, v0, u1, v1, colors,
                 MODE_ATLAS, 0.0, 0.0, params);
    if (blend_e) {
      uint8_t bc[4][4];
      for (int i = 0; i < 4; i++) {
        std::memcpy(bc[i], colors[i], 4);
        bc[i][3] = (uint8_t)std::floor((double)colors[i][3] * blend_t + 0.5);
      }
      double bu0 = blend_e->x, bv0 = blend_e->y;
      double bu1 = blend_e->x + blend_e->w, bv1 = blend_e->y + blend_e->h;
      if (flip) { double t = bv0; bv0 = bv1; bv1 = t; }
      draw_uv_rect(ctx, bx, by, bx + drw, by + drh, bu0, bv0, bu1, bv1, bc,
                   MODE_ATLAS, 0.0, 0.0, params);
    }
  } else {
    // MSDF / MTSDF (figrender.nim:1686-1732 parameter resolution)
    double px_range = n.px_range > 0.0f ? n.px_range : 4.0;
    double thr = (n.sd_threshold > 0.0f && n.sd_threshold < 1.0f)
                     ? n.sd_threshold : 0.5;
    double stroke_w = ctx.s(n.msdf_stroke > 0.0f ? n.msdf_stroke : 0.0f);
    double params[4] = {(double)ctx.atlas_size, stroke_w, 0, 0};
    int mode;
    if (n.kind == NK_MSDF) mode = stroke_w > 0.0 ? MODE_MSDF_ANN : MODE_MSDF;
    else mode = stroke_w > 0.0 ? MODE_MTSDF_ANN : MODE_MTSDF;
    draw_uv_rect(ctx, bx, by, bx + drw, by + drh, u0, v0, u1, v1, colors, mode,
                 px_range, thr, params);
  }
}



// text/glyphs.py glyph_hash: FNV-1a style mix, identical in Python and here
inline uint64_t glyph_key(int64_t font_id, int32_t glyph_id, bool lcd,
                          int variant) {
  uint64_t h = 0xCBF29CE484222325ull;
  const uint64_t vals[5] = {2344ull, (uint64_t)font_id, (uint64_t)glyph_id,
                            lcd ? 1ull : 0ull, (uint64_t)variant};
  for (int i = 0; i < 5; i++) {
    h ^= vals[i];
    h *= 0x100000001B3ull;
  }
  return h & 0x7FFFFFFFFFFFFFFFull;
}

// renderText port over packed rows (text/glyphs.py draw_text_layout):
// selection/decoration rects then per-glyph atlas quads, with the subpixel
// snap/variant policy and the glyph-raster origin offsets.
void render_text_node(Ctx& ctx, const Fig& n) {
  ctx.mats.push_back(ctx.mat);
  ctx.mat = matmul(ctx.mat, mat_translate(ctx.s(n.box[0]), ctx.s(n.box[1])));
  if (n.flags & NF_INVERT_Y) {
    ctx.mat = matmul(ctx.mat, mat_translate(0.0, ctx.s(n.box[3])));
    ctx.mat = matmul(ctx.mat, mat_scale(1.0, -1.0));
  }
  double zero4[4] = {0, 0, 0, 0};
  if (ctx.trects) {
    for (int i = n.trects_start; i < n.trects_start + n.trects_count; i++) {
      const TextRect& tr = ctx.trects[i];
      draw_rounded_rect(ctx, ctx.s(tr.x), ctx.s(tr.y), ctx.s(tr.w),
                        ctx.s(tr.h), tr.fill, zero4, zero4, MODE_CLIP_AA, 4.0,
                        0.0, 0.0, 0.0);
    }
  }
  if (ctx.glyphs) {
    for (int i = n.glyphs_start; i < n.glyphs_start + n.glyphs_count; i++) {
      const GlyphRow& g = ctx.glyphs[i];
      double gx = ctx.s(g.x) + g.img_ox;
      double gy = ctx.s(g.y) + g.img_oy;
      double shift = 0.0;
      int variant = 0;
      if (ctx.text_subpixel) {
        double snapped = std::floor(gx);
        double frac = gx - snapped;
        if (frac < 0.0) frac = 0.0;
        if (frac > 0.999) frac = 0.999;
        gx = snapped;
        if (ctx.text_variants) {
          variant = (int)(frac * 10.0);
          if (variant > 9) variant = 9;
        } else {
          shift = frac;
        }
      }
      uint64_t key = glyph_key(g.font_id, g.glyph_id, ctx.text_lcd, variant);
      const AtlasEntry* e = ctx.find_entry((int64_t)key, 0);
      if (!e) continue;  // renderer pre-pass rasterizes misses
      const float* off = ctx.find_glyph_offset((int64_t)key);
      double ox = off ? off[0] : 0.0, oy = off ? off[1] : 0.0;
      double drw = e->w * ctx.atlas_size, drh = e->h * ctx.atlas_size;
      uint8_t colors[4][4];
      gradient_colors(g.fill, colors);
      double params[4] = {0, 0, 0, 0};
      ctx.subpixel_shift = shift;
      draw_uv_rect(ctx, gx + ox, gy + oy, gx + ox + drw, gy + oy + drh,
                   e->x, e->y, e->x + e->w, e->y + e->h, colors, MODE_ATLAS,
                   0.0, 0.0, params);
      ctx.subpixel_shift = 0.0;
    }
  }
  ctx.mat = ctx.mats.back();
  ctx.mats.pop_back();
}

// ---- drawable decomposition (render.py port of figrender.nim:908-1651) -------

struct V2 { double x = 0, y = 0; };
inline V2 operator+(V2 a, V2 b) { return {a.x + b.x, a.y + b.y}; }
inline V2 operator-(V2 a, V2 b) { return {a.x - b.x, a.y - b.y}; }
inline V2 operator*(V2 a, double s) { return {a.x * s, a.y * s}; }
inline V2 operator/(V2 a, double s) { return {a.x / s, a.y / s}; }
inline double vlen(V2 v) { return std::sqrt(v.x * v.x + v.y * v.y); }
inline double vdot(V2 a, V2 b) { return a.x * b.x + a.y * b.y; }
inline double vcross(V2 a, V2 b) { return a.x * b.y - a.y * b.x; }
inline V2 norm_or(V2 v, V2 fb) {
  double l = vlen(v);
  return l <= 1e-6 ? fb : V2{v.x / l, v.y / l};
}
inline V2 normal_left(V2 d) { return {-d.y, d.x}; }

struct DrawCtx {
  Ctx* ctx;
  V2 origin;                 // node.screen_box.xy (unscaled)
  PackedFill fill;           // node fill
  PackedFill stroke_fill;    // drawable stroke fill
  double weight;             // stroke weight (unscaled)
  uint8_t cap, join;
  uint16_t node_steps;
};

// render_rounded_shape: unscaled box + corner radii → fill/stroke quads
void rounded_shape(Ctx& ctx, double x, double y, double w, double h,
                   const PackedFill& fill, double stroke_weight,
                   const PackedFill& stroke_fill, const double rx[4],
                   const double ry[4]) {
  double sx = ctx.s(x), sy = ctx.s(y), sw = ctx.s(w), sh = ctx.s(h);
  double srx[4], sry[4];
  for (int i = 0; i < 4; i++) { srx[i] = ctx.s(rx[i]); sry[i] = ctx.s(ry[i]); }
  if (fill_alpha_max(fill) > 0)
    draw_rounded_rect(ctx, sx, sy, sw, sh, fill, srx, sry, MODE_CLIP_AA, 4.0,
                      0.0, 0.0, 0.0);
  if (fill_alpha_max(stroke_fill) > 0 && stroke_weight > 0)
    draw_rounded_rect(ctx, sx, sy, sw, sh, stroke_fill, srx, sry,
                      MODE_ANNULAR_AA, ctx.s(stroke_weight), 0.0, 0.0, 0.0);
}

inline double radius_corner(double r) {
  // render.py _radius_corner: Python round() = half-to-even
  if (r <= 0.0) return 0.0;
  if (r >= 65535.0) return 65535.0;
  return std::nearbyint(r);
}

void stroke_cap_circle(DrawCtx& dc, V2 center, double radius,
                       const PackedFill& fill) {
  if (radius <= 0.0 || fill_alpha_max(fill) == 0) return;
  double d = radius * 2.0;
  double rr = radius_corner(radius);
  double rx[4] = {rr, rr, rr, rr};
  PackedFill none{};
  rounded_shape(*dc.ctx, center.x - radius, center.y - radius, d, d, fill, 0.0,
                none, rx, rx);
}

void drawable_line_seg(DrawCtx& dc, V2 a, V2 b, uint8_t cap,
                       const PackedFill& fill, double weight) {
  weight = weight < 0.0 ? 0.0 : weight;
  if (weight <= 0.0 || fill_alpha_max(fill) == 0) return;
  a = dc.origin + a;
  b = dc.origin + b;
  V2 delta = b - a;
  double length = vlen(delta);
  if (length <= 0.0) return;
  if (cap == CAP_AUTO) cap = CAP_BUTT;  // resolveLineCap
  double cap_radius = weight * 0.5;
  V2 dir = delta / length;
  V2 da = a, db = b;
  double dlen = length;
  if (cap == CAP_SQUARE) {
    da = a - dir * cap_radius;
    db = b + dir * cap_radius;
    dlen = length + weight;
  }
  V2 center = (da + db) / 2.0;
  double bx = center.x - dlen / 2.0, by = center.y - weight / 2.0;
  // pivot in scaled space (figrender.nim:975-991)
  double sbx = dc.ctx->s(bx), sby = dc.ctx->s(by);
  double sbw = dc.ctx->s(dlen), sbh = dc.ctx->s(weight);
  double px = sbx + sbw / 2.0, py = sby + sbh / 2.0;
  double angle = std::atan2(delta.y, delta.x);

  Ctx& ctx = *dc.ctx;
  ctx.mats.push_back(ctx.mat);
  ctx.mat = matmul(ctx.mat, mat_translate(px, py));
  ctx.mat = matmul(ctx.mat, mat_rotate(angle));
  ctx.mat = matmul(ctx.mat, mat_translate(-px, -py));
  double zero4[4] = {0, 0, 0, 0};
  PackedFill none{};
  rounded_shape(ctx, bx, by, dlen, weight, fill, 0.0, none, zero4, zero4);
  ctx.mat = ctx.mats.back();
  ctx.mats.pop_back();

  if (cap == CAP_ROUND) {
    stroke_cap_circle(dc, a, cap_radius, fill);
    stroke_cap_circle(dc, b, cap_radius, fill);
  }
}

void filled_quad(DrawCtx& dc, const V2 v[4], const PackedFill& fill) {
  if (fill_alpha_max(fill) == 0) return;
  Ctx& ctx = *dc.ctx;
  uint8_t center[4];
  fill_sample(fill, 0.5, center);
  uint8_t colors[4][4];
  for (int i = 0; i < 4; i++) std::memcpy(colors[i], center, 4);
  double pq[4][2];
  for (int i = 0; i < 4; i++) {
    double sx = ctx.s(v[i].x), sy = ctx.s(v[i].y);
    pq[i][0] = std::ceil(ctx.mat.a * sx + ctx.mat.b * sy + ctx.mat.tx);
    pq[i][1] = std::ceil(ctx.mat.c * sx + ctx.mat.d * sy + ctx.mat.ty);
  }
  double uv[4][2];
  for (int i = 0; i < 4; i++) { uv[i][0] = ctx.white_u; uv[i][1] = ctx.white_v; }
  double params[4] = {0, 0, 0, 0}, radii[4] = {0, 0, 0, 0}, factors[2] = {0, 0};
  emit_quad(ctx, pq, uv, colors, params, radii, factors, MODE_ATLAS, nullptr,
            nullptr);
}

void endpoint_cap(DrawCtx& dc, V2 point, V2 tangent, double radius,
                  uint8_t cap, bool is_start) {
  if (radius <= 0.0 || fill_alpha_max(dc.stroke_fill) == 0) return;
  if (cap == CAP_ROUND) {
    stroke_cap_circle(dc, dc.origin + point, radius, dc.stroke_fill);
  } else if (cap == CAP_SQUARE) {
    V2 dir = norm_or(tangent, {1.0, 0.0});
    V2 a = is_start ? point - dir * radius : point;
    V2 b = is_start ? point : point + dir * radius;
    drawable_line_seg(dc, a, b, CAP_BUTT, dc.stroke_fill, dc.weight);
  }
}

void stroke_join(DrawCtx& dc, V2 point, V2 in_t, V2 out_t, double radius,
                 uint8_t join) {
  if (radius <= 0.0 || fill_alpha_max(dc.stroke_fill) == 0) return;
  if (join == JOIN_ROUND) {
    stroke_cap_circle(dc, dc.origin + point, radius, dc.stroke_fill);
    return;
  }
  if (join != JOIN_BEVEL && join != JOIN_MITER) return;
  V2 incoming = norm_or(in_t, {1.0, 0.0});
  V2 outgoing = norm_or(out_t, incoming);
  double turn = vcross(incoming, outgoing);
  if (std::fabs(turn) <= 1e-4) return;
  double side = turn > 0.0 ? -1.0 : 1.0;
  V2 in_outer = point + normal_left(incoming) * (radius * side);
  V2 out_outer = point + normal_left(outgoing) * (radius * side);
  if (join == JOIN_MITER) {
    double denom = vcross(incoming, outgoing);
    if (std::fabs(denom) > 1e-6) {
      double t = vcross(out_outer - in_outer, outgoing) / denom;
      V2 miter = in_outer + incoming * t;
      if (vlen(miter - point) <= radius * 4.0) {
        V2 q[4] = {dc.origin + point, dc.origin + in_outer, dc.origin + miter,
                   dc.origin + out_outer};
        filled_quad(dc, q, dc.stroke_fill);
        return;
      }
    }
  }
  V2 q[4] = {dc.origin + point, dc.origin + in_outer, dc.origin + out_outer,
             dc.origin + out_outer};
  filled_quad(dc, q, dc.stroke_fill);
}

// quadratic bezier SDF quad emission (tape.py draw_quadratic_bezier_sdf)
void quad_bezier_sdf(Ctx& ctx, double rx, double ry, double rw, double rh,
                     const PackedFill& fill, V2 p0, V2 p1, V2 p2,
                     double stroke_weight, uint8_t cap) {
  if (rw <= 0.0 || rh <= 0.0 || stroke_weight <= 0.0) return;
  int fill_mode = 0;
  uint8_t colors[4][4];
  const uint8_t* midc = nullptr;
  const uint8_t* stopc = nullptr;
  double mid_pos = 0.5;
  if (fill.kind == 2) {
    static const int axis_to_mode[4] = {1, 2, 3, 4};
    fill_mode = axis_to_mode[fill.axis & 3];
    for (int v = 0; v < 4; v++) std::memcpy(colors[v], fill.c0, 4);
    midc = fill.c1;
    stopc = fill.c2;
    double mp = fill.midpos / 255.0;
    mid_pos = mp < 0.01 ? 0.01 : (mp > 0.99 ? 0.99 : mp);
  } else {
    gradient_colors(fill, colors);
  }
  double qhx = rw * 0.5, qhy = rh * 0.5;
  double params[4] = {qhx, qhy, p0.x, p0.y};
  double curve[4] = {p1.x, p1.y, p2.x, p2.y};
  double factors[2];
  factors[0] = stroke_weight;
  factors[1] = fill_mode == 0 ? 0.0 : mid_pos;
  int base_mode = cap == CAP_BUTT ? MODE_BEZ_BUTT
                  : (cap == CAP_SQUARE ? MODE_BEZ_SQUARE : MODE_BEZ_ROUND);
  double pq[4][2];
  pos_quad(ctx.mat, rx, ry, rx + rw, ry + rh, pq);
  static const double uv[4][2] = {{0, 1}, {1, 1}, {1, 0}, {0, 0}};
  emit_quad(ctx, pq, uv, colors, params, curve, factors,
            base_mode + fill_mode * 256, midc, stopc);
}

inline V2 bezier_point(const V2* ctrl, int n, double t) {
  V2 work[16];
  int count = n < 16 ? n : 16;
  for (int i = 0; i < count; i++) work[i] = ctrl[i];
  while (count > 1) {
    for (int i = 0; i < count - 1; i++)
      work[i] = work[i] * (1.0 - t) + work[i + 1] * t;
    count--;
  }
  return work[0];
}

inline V2 quadratic_point(V2 p0, V2 p1, V2 p2, double t) {
  double it = 1.0 - t;
  return p0 * (it * it) + p1 * (2.0 * it * t) + p2 * (t * t);
}

struct QSpan { V2 p0, p1, p2; };

inline V2 span_start_tangent(const QSpan& s) {
  return norm_or(s.p1 - s.p0, norm_or(s.p2 - s.p0, {1.0, 0.0}));
}
inline V2 span_end_tangent(const QSpan& s) {
  return norm_or(s.p2 - s.p1, norm_or(s.p2 - s.p0, {1.0, 0.0}));
}

inline QSpan make_span(const V2* ctrl, int n, double t0, double t2) {
  double tm = (t0 + t2) * 0.5;
  V2 p0 = bezier_point(ctrl, n, t0);
  V2 pm = bezier_point(ctrl, n, tm);
  V2 p2 = bezier_point(ctrl, n, t2);
  V2 p1 = pm * 2.0 - (p0 + p2) * 0.5;
  return {p0, p1, p2};
}

void adaptive_spans(const Ctx& ctx, const V2* ctrl, int n, double t0, double t2,
                    int depth, std::vector<QSpan>& out) {
  QSpan span = make_span(ctrl, n, t0, t2);
  double err = 0.0;
  const double locals[2] = {0.25, 0.75};
  for (double lt : locals) {
    double t = t0 + (t2 - t0) * lt;
    V2 actual = bezier_point(ctrl, n, t);
    V2 approx = quadratic_point(span.p0, span.p1, span.p2, lt);
    V2 d = {(actual.x - approx.x) * ctx.ui_scale,
            (actual.y - approx.y) * ctx.ui_scale};
    double e = vlen(d);
    if (e > err) err = e;
  }
  if (err <= ADAPTIVE_TOL_PX || depth >= MAX_ADAPTIVE_DEPTH ||
      (int)out.size() >= MAX_ADAPTIVE_STEPS - 1) {
    out.push_back(span);
  } else {
    double tm = (t0 + t2) * 0.5;
    adaptive_spans(ctx, ctrl, n, t0, tm, depth + 1, out);
    adaptive_spans(ctx, ctrl, n, tm, t2, depth + 1, out);
  }
}

inline bool is_flat_quadratic(V2 p0, V2 p1, V2 p2) {
  return std::fabs(vcross(p1 - p0, p2 - p1)) <= 1e-4;
}

void drawable_quad_bezier(DrawCtx& dc, V2 p0, V2 p1, V2 p2, uint8_t cap) {
  uint8_t resolved = cap;
  if (resolved == CAP_AUTO)
    resolved = dc.cap == CAP_AUTO ? CAP_ROUND : dc.cap;  // resolveCurveCap
  if (is_flat_quadratic(p0, p1, p2)) {
    drawable_line_seg(dc, p0, p2, resolved, dc.stroke_fill, dc.weight);
    return;
  }
  double sw = dc.weight < 0.0 ? 0.0 : dc.weight;
  double padding = sw * 0.5 + SDF_PADDING_PX / dc.ctx->ui_scale;
  V2 a = dc.origin + p0, b = dc.origin + p1, c = dc.origin + p2;
  // quadratic bounds (figrender.nim:1171-1193)
  double mnx = a.x < c.x ? a.x : c.x, mny = a.y < c.y ? a.y : c.y;
  double mxx = a.x > c.x ? a.x : c.x, mxy = a.y > c.y ? a.y : c.y;
  double denom_x = a.x - 2.0 * b.x + c.x;
  if (std::fabs(denom_x) > 1e-6) {
    double t = (a.x - b.x) / denom_x;
    if (t > 0.0 && t < 1.0) {
      V2 q = quadratic_point(a, b, c, t);
      mnx = q.x < mnx ? q.x : mnx; mxx = q.x > mxx ? q.x : mxx;
      mny = q.y < mny ? q.y : mny; mxy = q.y > mxy ? q.y : mxy;
    }
  }
  double denom_y = a.y - 2.0 * b.y + c.y;
  if (std::fabs(denom_y) > 1e-6) {
    double t = (a.y - b.y) / denom_y;
    if (t > 0.0 && t < 1.0) {
      V2 q = quadratic_point(a, b, c, t);
      mnx = q.x < mnx ? q.x : mnx; mxx = q.x > mxx ? q.x : mxx;
      mny = q.y < mny ? q.y : mny; mxy = q.y > mxy ? q.y : mxy;
    }
  }
  double bx = mnx - padding, by = mny - padding;
  double bw = mxx - mnx + padding * 2.0, bh = mxy - mny + padding * 2.0;
  if (bw <= 0.0 || bh <= 0.0) return;
  V2 center = {bx + bw * 0.5, by + bh * 0.5};
  Ctx& ctx = *dc.ctx;
  quad_bezier_sdf(ctx, ctx.s(bx), ctx.s(by), ctx.s(bw), ctx.s(bh),
                  dc.stroke_fill,
                  {ctx.s(a.x - center.x), ctx.s(a.y - center.y)},
                  {ctx.s(b.x - center.x), ctx.s(b.y - center.y)},
                  {ctx.s(c.x - center.x), ctx.s(c.y - center.y)},
                  ctx.s(sw), resolved);
}

void spans_with_joins(DrawCtx& dc, const std::vector<QSpan>& spans) {
  uint8_t cap = dc.cap == CAP_AUTO ? CAP_ROUND : dc.cap;
  uint8_t join = dc.join == JOIN_AUTO ? JOIN_ROUND : dc.join;
  bool simple_round = cap == CAP_ROUND && join == JOIN_ROUND;
  uint8_t span_cap = simple_round ? CAP_ROUND : CAP_BUTT;
  double cap_radius = (dc.weight < 0.0 ? 0.0 : dc.weight) / 2.0;
  for (size_t i = 0; i < spans.size(); i++) {
    const QSpan& sp = spans[i];
    drawable_quad_bezier(dc, sp.p0, sp.p1, sp.p2, span_cap);
    if (!simple_round) {
      if (i == 0)
        endpoint_cap(dc, sp.p0, span_start_tangent(sp), cap_radius, cap, true);
      else
        stroke_join(dc, sp.p0, span_end_tangent(spans[i - 1]),
                    span_start_tangent(sp), cap_radius, join);
      if (i == spans.size() - 1)
        endpoint_cap(dc, sp.p2, span_end_tangent(sp), cap_radius, cap, false);
    }
  }
}

void drawable_bezier(DrawCtx& dc, const V2* ctrl, int n, uint16_t steps) {
  if (n < 2) return;
  if (dc.weight <= 0.0 || fill_alpha_max(dc.stroke_fill) == 0) return;
  if (n == 3) {
    drawable_quad_bezier(dc, ctrl[0], ctrl[1], ctrl[2], CAP_AUTO);
    return;
  }
  if (n > 3) {
    int fixed = steps != 0 ? (steps < 1 ? 1 : steps)
                           : (dc.node_steps != 0 ? dc.node_steps : 0);
    std::vector<QSpan> spans;
    if (fixed > 0) {
      for (int i = 0; i < fixed; i++)
        spans.push_back(make_span(ctrl, n, (double)i / fixed,
                                  (double)(i + 1) / fixed));
    } else {
      adaptive_spans(*dc.ctx, ctrl, n, 0.0, 1.0, 0, spans);
    }
    spans_with_joins(dc, spans);
    return;
  }
  // 2 control points: polyline segments (figrender.nim:1368-1412)
  int fixed = steps != 0 ? steps : dc.node_steps;
  std::vector<V2> points;
  points.push_back(bezier_point(ctrl, n, 0.0));
  if (fixed > 0) {
    for (int i = 1; i <= fixed; i++)
      points.push_back(bezier_point(ctrl, n, (double)i / fixed));
  } else {
    // adaptive segment splitting
    struct Rec {
      static void go(const Ctx& ctx, const V2* c, int n, double t0, double t2,
                     int depth, std::vector<V2>& pts) {
        V2 p0 = bezier_point(c, n, t0);
        V2 p2 = bezier_point(c, n, t2);
        double tm = (t0 + t2) * 0.5;
        V2 pm = bezier_point(c, n, tm);
        // distance to line in scaled px
        V2 sa = {p0.x * ctx.ui_scale, p0.y * ctx.ui_scale};
        V2 sb = {p2.x * ctx.ui_scale, p2.y * ctx.ui_scale};
        V2 sp = {pm.x * ctx.ui_scale, pm.y * ctx.ui_scale};
        V2 ab = sb - sa;
        double dden = vdot(ab, ab);
        double err;
        if (dden <= 1e-6) err = vlen(sp - sa);
        else {
          double h = vdot(sp - sa, ab) / dden;
          h = h < 0.0 ? 0.0 : (h > 1.0 ? 1.0 : h);
          err = vlen(sp - (sa + ab * h));
        }
        if (err <= ADAPTIVE_TOL_PX || depth >= MAX_ADAPTIVE_DEPTH ||
            (int)pts.size() >= MAX_ADAPTIVE_STEPS) {
          pts.push_back(p2);
        } else {
          go(ctx, c, n, t0, tm, depth + 1, pts);
          go(ctx, c, n, tm, t2, depth + 1, pts);
        }
      }
    };
    Rec::go(*dc.ctx, ctrl, n, 0.0, 1.0, 0, points);
  }
  if (points.size() < 2) return;
  uint8_t cap = dc.cap == CAP_AUTO ? CAP_ROUND : dc.cap;
  uint8_t join = dc.join == JOIN_AUTO ? JOIN_ROUND : dc.join;
  double cap_radius = (dc.weight < 0.0 ? 0.0 : dc.weight) / 2.0;
  V2 prev = points[0];
  V2 prev_t = {1.0, 0.0};
  for (size_t i = 1; i < points.size(); i++) {
    V2 cur = points[i];
    V2 tangent = cur - prev;
    drawable_line_seg(dc, prev, cur, CAP_BUTT, dc.stroke_fill, dc.weight);
    if (i == 1)
      endpoint_cap(dc, prev, tangent, cap_radius, cap, true);
    else
      stroke_join(dc, prev, prev_t, tangent, cap_radius, join);
    if (i == points.size() - 1)
      endpoint_cap(dc, cur, tangent, cap_radius, cap, false);
    prev = cur;
    prev_t = tangent;
  }
}

void drawable_arc(DrawCtx& dc, V2 center, double radius, double a0,
                  double sweep, uint16_t steps) {
  radius = radius < 0.0 ? 0.0 : radius;
  if (radius <= 0.0 || sweep == 0.0) return;
  if (dc.weight <= 0.0 || fill_alpha_max(dc.stroke_fill) == 0) return;
  int count;
  int explicit_steps = steps != 0 ? steps : dc.node_steps;
  if (explicit_steps > 0) {
    count = explicit_steps < 1 ? 1 : explicit_steps;
  } else {
    double radius_px = dc.ctx->s(radius);
    double abs_sweep = std::fabs(sweep);
    if (radius_px <= 0.0 || abs_sweep <= 0.0) count = 1;
    else {
      double cl = 1.0 - ADAPTIVE_TOL_PX / radius_px;
      cl = cl < -1.0 ? -1.0 : (cl > 1.0 ? 1.0 : cl);
      double max_angle = 2.0 * std::acos(cl);
      if (max_angle < 0.01) max_angle = 0.01;
      count = (int)std::ceil(abs_sweep / max_angle);
      if (count < 1) count = 1;
      if (count > MAX_ADAPTIVE_STEPS) count = MAX_ADAPTIVE_STEPS;
    }
  }
  std::vector<QSpan> spans;
  for (int i = 0; i < count; i++) {
    double t0 = (double)i / count, t2 = (double)(i + 1) / count;
    double tm = (t0 + t2) * 0.5;
    double an0 = a0 + sweep * t0, an2 = a0 + sweep * t2, anm = a0 + sweep * tm;
    V2 p0 = center + V2{std::cos(an0) * radius, std::sin(an0) * radius};
    V2 pm = center + V2{std::cos(anm) * radius, std::sin(anm) * radius};
    V2 p2 = center + V2{std::cos(an2) * radius, std::sin(an2) * radius};
    V2 p1 = pm * 2.0 - (p0 + p2) * 0.5;
    spans.push_back({p0, p1, p2});
  }
  spans_with_joins(dc, spans);
}

void render_drawable_node(Ctx& ctx, const Fig& n, const DrawOp* ops,
                          const float* points) {
  DrawCtx dc;
  dc.ctx = &ctx;
  dc.origin = {n.box[0], n.box[1]};
  dc.fill = n.fill;
  dc.stroke_fill = n.draw_stroke_fill;
  dc.weight = n.draw_weight;
  dc.cap = n.draw_cap;
  dc.join = n.draw_join;
  dc.node_steps = n.draw_steps;

  double old_aa = ctx.aa;
  if (n.draw_aa > 0.0f && n.draw_aa != old_aa) ctx.aa = n.draw_aa;

  for (int oi = n.ops_start; oi < n.ops_start + n.ops_count; oi++) {
    const DrawOp& op = ops[oi];
    const float* d = op.data;
    switch (op.kind) {
      case DK_LINE:
        drawable_line_seg(dc, {d[0], d[1]}, {d[2], d[3]}, dc.cap,
                          dc.stroke_fill, dc.weight);
        break;
      case DK_CIRCLE: {
        double r = d[2] < 0.0f ? 0.0 : d[2];
        if (r <= 0.0) break;
        double rr = radius_corner(r);
        double rx[4] = {rr, rr, rr, rr};
        rounded_shape(ctx, dc.origin.x + d[0] - r, dc.origin.y + d[1] - r,
                      r * 2.0, r * 2.0, dc.fill, dc.weight, dc.stroke_fill,
                      rx, rx);
        break;
      }
      case DK_RECT: {
        double rx[4] = {d[4], d[5], d[6], d[7]};
        rounded_shape(ctx, dc.origin.x + d[0], dc.origin.y + d[1], d[2], d[3],
                      dc.fill, dc.weight, dc.stroke_fill, rx, rx);
        break;
      }
      case DK_BEZIER: {
        int pc = op.p_count;
        if (pc >= 2 && pc <= 16) {
          V2 ctrl[16];
          for (int i = 0; i < pc; i++)
            ctrl[i] = {points[(op.p_start + i) * 2],
                       points[(op.p_start + i) * 2 + 1]};
          drawable_bezier(dc, ctrl, pc, op.steps);
        }
        break;
      }
      case DK_ARC:
        drawable_arc(dc, {d[0], d[1]}, d[2], d[3], d[4], op.steps);
        break;
      case DK_ELLIPSE: {
        double rx_ = d[2] < 0.0f ? 0.0 : d[2];
        double ry_ = d[3] < 0.0f ? 0.0 : d[3];
        if (rx_ <= 0.0 || ry_ <= 0.0) break;
        double cx[4] = {rx_, rx_, rx_, rx_};
        double cy[4] = {ry_, ry_, ry_, ry_};
        rounded_shape(ctx, dc.origin.x + d[0] - rx_, dc.origin.y + d[1] - ry_,
                      rx_ * 2.0, ry_ * 2.0, dc.fill, dc.weight, dc.stroke_fill,
                      cx, cy);
        break;
      }
    }
  }
  ctx.aa = old_aa;
}

void begin_mask(Ctx& ctx, double rx, double ry, double rw, double rh,
                const double radx[4], const double rady[4]) {
  ctx.close_run();
  ctx.mask_begun = true;
  ctx.mask_write++;
  if (ctx.mask_write > ctx.mask_count) ctx.mask_count = ctx.mask_write;
  ctx.items.push_back({2, ctx.mask_write, 0, 0, 0.0f});
  if ((int)ctx.plane_support.size() <= ctx.mask_write)
    ctx.plane_support.resize(ctx.mask_write + 1);
  // the clear empties the plane; write quads re-grow the support
  ctx.plane_support[ctx.mask_write] = {2e9f, 2e9f, -2e9f, -2e9f};
  PackedFill red{};
  red.kind = 0;
  red.c0[0] = 255; red.c0[3] = 255;
  draw_rounded_rect(ctx, rx, ry, rw, rh, red, radx, rady, MODE_CLIP_AA, 4.0, 0.0,
                    0.0, 0.0);
}

void end_mask(Ctx& ctx) {
  ctx.close_run();
  ctx.mask_begun = false;
}

void pop_mask(Ctx& ctx) {
  ctx.close_run();
  ctx.mask_write--;
}

void begin_rect_mask(Ctx& ctx, double rx, double ry, double rw, double rh,
                     const double radx[4], const double rady[4]) {
  if (ctx.rect_masks.empty() && rw > 0 && rh > 0) {
    RectMask rm{};
    rm.fast = true;
    double hx = rw * 0.5, hy = rh * 0.5;
    double cx = rx + hx, cy = ry + hy;
    // twin of tape._make_rect_mask: snap the local rect through the
    // transform round trip so the fast path clips at the same pixels as
    // the ceil-snapped mask-plane quad (axis-aligned transforms only)
    const Mat3& m = ctx.mat;
    if (m.b == 0.0 && m.c == 0.0 && m.a > 0.0 && m.d > 0.0) {
      Mat3 inv0 = mat_inverse(m);
      double p0x = m.a * rx + m.tx, p0y = m.d * ry + m.ty;
      double p1x = m.a * (rx + rw) + m.tx, p1y = m.d * (ry + rh) + m.ty;
      double s0x = std::ceil(p0x), s0y = std::ceil(p0y);
      double s1x = std::ceil(p1x), s1y = std::ceil(p1y);
      double l0x = inv0.a * s0x + inv0.b * s0y + inv0.tx;
      double l0y = inv0.c * s0x + inv0.d * s0y + inv0.ty;
      double l1x = inv0.a * s1x + inv0.b * s1y + inv0.tx;
      double l1y = inv0.c * s1x + inv0.d * s1y + inv0.ty;
      hx = (l1x - l0x) * 0.5; hy = (l1y - l0y) * 0.5;
      cx = l0x + hx; cy = l0y + hy;
    }
    rm.params[0] = cx; rm.params[1] = cy;
    rm.params[2] = hx; rm.params[3] = hy;
    PackedRadii pr = pack_radii(radx, rady, hx, hy);
    for (int i = 0; i < 4; i++) rm.radii[i] = pr.v[i];
    Mat3 inv = mat_inverse(ctx.mat);
    rm.matx[0] = inv.a; rm.matx[1] = inv.b; rm.matx[2] = inv.tx; rm.matx[3] = 1.0f;
    rm.maty[0] = inv.c; rm.maty[1] = inv.d; rm.maty[2] = inv.ty;
    rm.maty[3] = pr.elliptical ? 1.0f : 0.0f;
    ctx.rect_masks.push_back(rm);
  } else {
    begin_mask(ctx, rx, ry, rw, rh, radx, rady);
    end_mask(ctx);
    RectMask rm{};
    rm.fast = false;
    ctx.rect_masks.push_back(rm);
  }
}

void pop_rect_mask(Ctx& ctx) {
  bool fast = ctx.rect_masks.back().fast;
  ctx.rect_masks.pop_back();
  if (!fast) pop_mask(ctx);
}

void render_node(Ctx& ctx, const Fig* nodes, int n_nodes, int idx) {
  const Fig& n = nodes[idx];
  if (n.flags & NF_DISABLE) return;
  double bx = ctx.s(n.box[0]), by = ctx.s(n.box[1]);
  double bw = ctx.s(n.box[2]), bh = ctx.s(n.box[3]);

  bool did_rotation = n.rotation != 0.0f;
  if (did_rotation) {
    ctx.mats.push_back(ctx.mat);
    double cx = bx + bw * 0.5, cy = by + bh * 0.5;
    ctx.mat = matmul(ctx.mat, mat_translate(cx, cy));
    ctx.mat = matmul(ctx.mat, mat_rotate((double)n.rotation / 180.0 * 3.14159265358979311599796346854));
    ctx.mat = matmul(ctx.mat, mat_translate(-cx, -cy));
  }

  bool did_transform = n.kind == NK_TRANSFORM;
  if (did_transform) {
    ctx.mats.push_back(ctx.mat);
    if (n.tx != 0.0f || n.ty != 0.0f)
      ctx.mat = matmul(ctx.mat, mat_translate(ctx.s(n.tx), ctx.s(n.ty)));
    if (n.use_matrix) {
      Mat3 m;
      m.a = n.matrix[0]; m.b = n.matrix[1]; m.tx = n.matrix[2];
      m.c = n.matrix[3]; m.d = n.matrix[4]; m.ty = n.matrix[5];
      ctx.mat = matmul(ctx.mat, m);
    }
  }

  double radx[4], rady[4];
  node_corners(ctx, n, radx, rady);

  if (n.kind == NK_RECT) {
    // drop shadows (figrender.nim:654-689)
    for (int i = 0; i < 4; i++) {
      const PackedShadow& sh = n.shadows[i];
      if (sh.style != 1) continue;
      if (sh.blur <= 0.0f && sh.spread <= 0.0f) continue;
      if (fill_alpha_max(sh.fill) == 0) continue;
      double sx = ctx.s(sh.x), sy = ctx.s(sh.y);
      double sblur = ctx.s(sh.blur), sspread = ctx.s(sh.spread);
      double blur_pad = round_away(1.5 * sblur);
      double pad = round_away(sspread) + blur_pad;
      if (pad < 0.0) pad = 0.0;
      double srx = bx + sx, sry = by + sy;
      draw_rounded_rect(ctx, srx - pad, sry - pad, bw + 2 * pad, bh + 2 * pad,
                        sh.fill, radx, rady, MODE_DROP, sblur, sspread, bw, bh);
    }
  }

  bool did_clip = (n.flags & NF_CLIP) != 0;
  if (did_clip) {
    begin_mask(ctx, bx, by, bw, bh, radx, rady);
    end_mask(ctx);
  }
  bool did_rect_mask = (n.flags & NF_RECTMASK) != 0;
  if (did_rect_mask) begin_rect_mask(ctx, bx, by, bw, bh, radx, rady);

  if (n.kind == NK_RECT) {
    // fill + stroke (figrender.nim:806-873)
    if (fill_alpha_max(n.fill) > 0)
      draw_rounded_rect(ctx, bx, by, bw, bh, n.fill, radx, rady, MODE_CLIP_AA,
                        4.0, 0.0, 0.0, 0.0);
    if (fill_alpha_max(n.stroke_fill) > 0 && n.stroke_weight > 0)
      draw_rounded_rect(ctx, bx, by, bw, bh, n.stroke_fill, radx, rady,
                        MODE_ANNULAR_AA, ctx.s(n.stroke_weight), 0.0, 0.0, 0.0);
  } else if (n.kind == NK_TEXT) {
    if (n.glyphs_count > 0 || n.trects_count > 0) render_text_node(ctx, n);
  } else if (n.kind == NK_DRAWABLE) {
    if (ctx.ops && n.ops_count > 0)
      render_drawable_node(ctx, n, ctx.ops, ctx.points);
  } else if (n.kind == NK_IMAGE || n.kind == NK_MSDF || n.kind == NK_MTSDF) {
    if (n.image_id != 0) draw_image_node(ctx, n, bx, by, bw, bh);
  } else if (n.kind == NK_BACKDROP) {
    if (n.blur > 0.0f && bw > 0 && bh > 0) {
      ctx.close_run();
      ctx.items.push_back({1, 0, 0, 0, (float)ctx.s(n.blur)});
      PackedFill white{};
      white.kind = 0;
      white.c0[0] = white.c0[1] = white.c0[2] = white.c0[3] = 255;
      draw_rounded_rect(ctx, bx, by, bw, bh, white, radx, rady, MODE_BACKDROP,
                        ctx.s(n.blur), 0.0, 0.0, 0.0);
    }
    if (fill_alpha_max(n.fill) > 0)
      draw_rounded_rect(ctx, bx, by, bw, bh, n.fill, radx, rady, MODE_CLIP_AA,
                        4.0, 0.0, 0.0, 0.0);
  }

  if (n.kind == NK_RECT) {
    // inner shadows (figrender.nim:716-744)
    for (int i = 0; i < 4; i++) {
      const PackedShadow& sh = n.shadows[i];
      if (sh.style != 2) continue;
      if (sh.blur <= 0.0f && sh.spread <= 0.0f) continue;
      if (fill_alpha_max(sh.fill) == 0) continue;
      draw_rounded_rect(ctx, bx, by, bw, bh, sh.fill, radx, rady, MODE_INSET,
                        ctx.s(sh.blur), ctx.s(sh.spread), ctx.s(sh.x), ctx.s(sh.y));
    }
  }

  // children: forward scan (fignodes.nim:165-177)
  int found = 0;
  for (int ci = idx + 1; ci < n_nodes && found < n.child_count; ci++) {
    if (nodes[ci].parent == idx) {
      found++;
      render_node(ctx, nodes, n_nodes, ci);
    }
  }

  if (did_rect_mask) pop_rect_mask(ctx);
  if (did_clip) pop_mask(ctx);
  if (did_transform) { ctx.mat = ctx.mats.back(); ctx.mats.pop_back(); }
  if (did_rotation) { ctx.mat = ctx.mats.back(); ctx.mats.pop_back(); }
}

}  // namespace


// ---- scene-building C API ------------------------------------------------------
//
// The reference exports its whole scene API over a C ABI so external hosts can
// build render lists without Nim (bindings/native_bindings.nim + dynlib.nim).
// This is the figdraw_tpu analog: hosts fill packed Fig/DrawOp rows (layouts in
// figdraw_flatten.h; identical to nodesarray.py FIG_DTYPE/OP_DTYPE), build
// layered render lists with the same O(1) addRoot/addChild semantics as
// fignodes.nim:316-374, and flatten to the quad tape in one call. The device
// side (JAX executor) consumes the exported tape.

struct FdLayer {
  int8_t zlevel = 0;
  std::vector<Fig> nodes;
  std::vector<int32_t> roots;
  std::vector<DrawOp> ops;
  std::vector<float> points;  // flat (n, 2)
  std::vector<GlyphRow> glyphs;  // pre-shaped text geometry (GLYPH_DTYPE rows)
  std::vector<TextRect> trects;
};

struct FdRenders {
  std::vector<FdLayer> layers;  // ascending zlevel

  FdLayer& layer(int zlevel) {
    size_t i = 0;
    while (i < layers.size() && layers[i].zlevel < zlevel) i++;
    if (i == layers.size() || layers[i].zlevel != zlevel) {
      FdLayer l;
      l.zlevel = (int8_t)zlevel;
      layers.insert(layers.begin() + i, std::move(l));
    }
    return layers[i];
  }
};

extern "C" {

FdRenders* fd_renders_new() { return new FdRenders(); }
void fd_renders_free(FdRenders* r) { delete r; }

// Append a root node (fignodes.nim addRoot: O(1)); returns its index.
int fd_renders_add_root(FdRenders* r, int zlevel, const void* fig) {
  FdLayer& l = r->layer(zlevel);
  Fig f;
  std::memcpy(&f, fig, sizeof(Fig));
  f.zlevel = (int8_t)zlevel;
  f.parent = -1;
  f.child_count = 0;
  int idx = (int)l.nodes.size();
  l.nodes.push_back(f);
  l.roots.push_back(idx);
  return idx;
}

// Append a child of `parent` (fignodes.nim addChild: children live after the
// parent, linked by parent index + childCount); returns its index, or -1 if
// the parent index is invalid.
int fd_renders_add_child(FdRenders* r, int zlevel, int parent, const void* fig) {
  FdLayer& l = r->layer(zlevel);
  if (parent < 0 || parent >= (int)l.nodes.size()) return -1;
  Fig f;
  std::memcpy(&f, fig, sizeof(Fig));
  f.zlevel = (int8_t)zlevel;
  f.parent = (int16_t)parent;
  f.child_count = 0;
  int idx = (int)l.nodes.size();
  l.nodes.push_back(f);
  l.nodes[parent].child_count++;
  return idx;
}

// Number of drawable ops already in a layer — the value to store in
// Fig.ops_start before appending that node's ops.
int fd_renders_op_count(FdRenders* r, int zlevel) {
  return (int)r->layer(zlevel).ops.size();
}

// Text geometry (pre-shaped, GLYPH_DTYPE / TRECT_DTYPE rows): read the
// counts into Fig.glyphs_start / trects_start, append the node's rows, set
// the node's counts, then add the node — the same pattern as drawable ops.
int fd_renders_glyph_count(FdRenders* r, int zlevel) {
  return (int)r->layer(zlevel).glyphs.size();
}

int fd_renders_trect_count(FdRenders* r, int zlevel) {
  return (int)r->layer(zlevel).trects.size();
}

int fd_renders_add_text(FdRenders* r, int zlevel, const void* glyphs,
                        int n_glyphs, const void* trects, int n_trects) {
  FdLayer& l = r->layer(zlevel);
  if (glyphs && n_glyphs > 0) {
    const GlyphRow* g = (const GlyphRow*)glyphs;
    l.glyphs.insert(l.glyphs.end(), g, g + n_glyphs);
  }
  if (trects && n_trects > 0) {
    const TextRect* t = (const TextRect*)trects;
    l.trects.insert(l.trects.end(), t, t + n_trects);
  }
  return (int)l.glyphs.size();
}

// Append one drawable op. For bezier ops pass the control points; p_start is
// rewritten to the layer's point pool offset. Returns the op index.
int fd_renders_add_op(FdRenders* r, int zlevel, const void* op,
                      const float* pts, int n_pts) {
  FdLayer& l = r->layer(zlevel);
  DrawOp o;
  std::memcpy(&o, op, sizeof(DrawOp));
  if (pts && n_pts > 0) {
    o.p_start = (int32_t)(l.points.size() / 2);
    o.p_count = n_pts;
    l.points.insert(l.points.end(), pts, pts + (size_t)n_pts * 2);
  }
  int idx = (int)l.ops.size();
  l.ops.push_back(o);
  return idx;
}

// Walk every layer in ascending zlevel (figrender renderRoot order) into the
// context's quad tape; combine with fd_quad_count/fd_export as usual.
void fd_flatten_renders(Ctx* ctx, FdRenders* r) {
  for (FdLayer& l : r->layers) {
    ctx->ops = l.ops.empty() ? nullptr : l.ops.data();
    ctx->points = l.points.empty() ? nullptr : l.points.data();
    ctx->glyphs = l.glyphs.empty() ? nullptr : l.glyphs.data();
    ctx->trects = l.trects.empty() ? nullptr : l.trects.data();
    for (int32_t root : l.roots)
      render_node(*ctx, l.nodes.data(), (int)l.nodes.size(), root);
  }
  ctx->ops = nullptr;
  ctx->points = nullptr;
  ctx->glyphs = nullptr;
  ctx->trects = nullptr;
}

// Fill helpers (filltypes.nim fill()/linear()): kind 0 solid, 1 linear2,
// 2 linear3; axis 0 X, 1 Y, 2 diag TL-BR, 3 diag BL-TR.
void fd_fill_solid(void* fill, uint8_t red, uint8_t green, uint8_t blue,
                   uint8_t alpha) {
  PackedFill* f = (PackedFill*)fill;
  std::memset(f, 0, sizeof(PackedFill));
  f->kind = 0;
  f->c0[0] = red; f->c0[1] = green; f->c0[2] = blue; f->c0[3] = alpha;
}

void fd_fill_linear2(void* fill, int axis, const uint8_t start[4],
                     const uint8_t stop[4]) {
  PackedFill* f = (PackedFill*)fill;
  std::memset(f, 0, sizeof(PackedFill));
  f->kind = 1;
  f->axis = (uint8_t)axis;
  std::memcpy(f->c0, start, 4);
  std::memcpy(f->c1, stop, 4);
}

void fd_fill_linear3(void* fill, int axis, const uint8_t start[4],
                     const uint8_t mid[4], const uint8_t stop[4],
                     uint8_t mid_pos) {
  PackedFill* f = (PackedFill*)fill;
  std::memset(f, 0, sizeof(PackedFill));
  f->kind = 2;
  f->axis = (uint8_t)axis;
  f->midpos = mid_pos;
  std::memcpy(f->c0, start, 4);
  std::memcpy(f->c1, mid, 4);
  std::memcpy(f->c2, stop, 4);
}

}  // extern "C"

extern "C" {

Ctx* fd_create(float ui_scale, float pixel_scale, float aa_factor) {
  Ctx* ctx = new Ctx();
  ctx->ui_scale = ui_scale;
  ctx->aa = aa_factor;
  ctx->mat = mat_scale(pixel_scale, pixel_scale);
  return ctx;
}

void fd_destroy(Ctx* ctx) {
  for (Ctx* w : ctx->workers) delete w;
  ctx->workers.clear();
  delete ctx;
}

// Reuse a context across frames: clears the logical tape/walk state but
// keeps the fields/modes/items allocations, so steady-state frames do no
// heap growth (the reference's "few or no allocations per frame" design
// target, README.md:7). Callers must re-set atlas/geometry/text state —
// fd_reset drops them so a walk without e.g. glyph offsets cannot see a
// previous frame's tables.
void fd_reset(Ctx* ctx, float ui_scale, float pixel_scale, float aa_factor) {
  ctx->ui_scale = ui_scale;
  ctx->aa = aa_factor;
  ctx->mat = mat_scale(pixel_scale, pixel_scale);
  ctx->white_u = 0.0;
  ctx->white_v = 0.0;
  ctx->ops = nullptr;
  ctx->points = nullptr;
  ctx->glyphs = nullptr;
  ctx->trects = nullptr;
  ctx->text_lcd = ctx->text_subpixel = ctx->text_variants = false;
  ctx->subpixel_shift = 0.0;
  ctx->glyph_off_keys.clear();
  ctx->glyph_offs.clear();
  ctx->atlas_entries.clear();
  ctx->atlas_size = 1.0f;
  ctx->mats.clear();
  ctx->count = 0;
  ctx->items.clear();
  ctx->mask_write = 0;
  ctx->mask_count = 0;
  ctx->mask_begun = false;
  ctx->plane_support.clear();
  ctx->merged = false;
  ctx->any_atlas = false;
  ctx->any_backdrop = false;
  ctx->rect_masks.clear();
  ctx->run_open = false;
  ctx->run_target = 0;
  ctx->run_mask = 0;
  ctx->run_start = 0;
}

// Atlas entry table for image/MSDF quads: parallel arrays sorted by
// (id, level); rects are normalized (x, y, w, h).
void fd_set_atlas(Ctx* ctx, const int64_t* ids, const int32_t* levels,
                  const float* rects, int n, float atlas_size) {
  ctx->atlas_size = atlas_size;
  ctx->atlas_entries.resize(n);
  for (int i = 0; i < n; i++) {
    ctx->atlas_entries[i] = {ids[i], levels[i], rects[i * 4 + 0],
                             rects[i * 4 + 1], rects[i * 4 + 2], rects[i * 4 + 3]};
  }
}

// Flatten one layer's roots in order. nodes: FIG_DTYPE rows; roots: indexes.
//
// Big flat layers walk in PARALLEL: roots are independent subtrees (their
// transform/rect-mask state is subtree-local), so contiguous root ranges
// walk into per-worker contexts on std::thread and stitch back in order —
// the quad stream is byte-identical to the serial walk. Guards: clip masks
// need global mask numbering (serial when any NF_CLIP is present), and the
// split breaks run continuity at range boundaries, which merge_items()
// restores at export (adjacent same-target draw items with end==start are
// exactly the runs one serial walk would have kept open).
static const int PAR_MIN_NODES = 4096;
static const int PAR_MIN_ROOTS = 64;

static void copy_walk_config(Ctx& dst, const Ctx& src) {
  dst.ui_scale = src.ui_scale;
  dst.aa = src.aa;
  dst.white_u = src.white_u;
  dst.white_v = src.white_v;
  dst.ops = src.ops;
  dst.points = src.points;
  dst.glyphs = src.glyphs;
  dst.trects = src.trects;
  dst.text_lcd = src.text_lcd;
  dst.text_subpixel = src.text_subpixel;
  dst.text_variants = src.text_variants;
  dst.subpixel_shift = 0.0;
  dst.glyph_off_keys = src.glyph_off_keys;
  dst.glyph_offs = src.glyph_offs;
  dst.atlas_entries = src.atlas_entries;
  dst.atlas_size = src.atlas_size;
  dst.mat = src.mat;
  dst.mats.clear();
  dst.count = 0;
  dst.items.clear();
  dst.mask_write = 0;
  dst.mask_count = 0;
  dst.mask_begun = false;
  dst.plane_support.clear();
  dst.merged = false;
  dst.any_atlas = false;
  dst.any_backdrop = false;
  dst.rect_masks.clear();
  dst.run_open = false;
  dst.run_start = 0;
}

void fd_flatten_layer(Ctx* ctx, const void* nodes, int n_nodes,
                      const int32_t* roots, int n_roots) {
  const Fig* figs = (const Fig*)nodes;
  ctx->merged = false;
  int hw = (int)std::thread::hardware_concurrency();
  // FIGDRAW_FLATTEN_THREADS forces the worker count (0/1 = serial): lets
  // tests exercise the threaded walk on single-core hosts and callers cap
  // it on shared machines
  if (const char* env = std::getenv("FIGDRAW_FLATTEN_THREADS")) {
    int forced = std::atoi(env);
    if (forced >= 0) hw = forced;
  }
  int k = std::min(hw > 0 ? hw : 1, 8);
  bool parallel = n_nodes >= PAR_MIN_NODES && n_roots >= PAR_MIN_ROOTS &&
                  k >= 2 && !ctx->mask_begun;
  if (parallel) {
    for (int i = 0; i < n_nodes; i++) {
      if (figs[i].flags & NF_CLIP) { parallel = false; break; }
    }
  }
  if (!parallel) {
    for (int i = 0; i < n_roots; i++)
      render_node(*ctx, figs, n_nodes, roots[i]);
    return;
  }
  // partition roots into k contiguous ranges balanced by node count
  // (children are stored after their parent, so root i's subtree spans
  // [roots[i], next root) — range sizes follow from the root indices)
  ctx->close_run();
  while ((int)ctx->workers.size() < k) ctx->workers.push_back(new Ctx());
  std::vector<int> range_start(k + 1, n_roots);
  range_start[0] = 0;
  for (int w = 1; w < k; w++) {
    int target = (int)((int64_t)n_nodes * w / k);
    int lo = range_start[w - 1], hi = n_roots;
    while (lo < hi) {
      int mid = (lo + hi) / 2;
      if (roots[mid] < target) lo = mid + 1;
      else hi = mid;
    }
    range_start[w] = lo;
  }
  std::vector<std::thread> threads;
  threads.reserve(k);
  for (int w = 0; w < k; w++) {
    Ctx* wc = ctx->workers[w];
    copy_walk_config(*wc, *ctx);
    int lo = range_start[w], hi = range_start[w + 1];
    threads.emplace_back([wc, figs, n_nodes, roots, lo, hi]() {
      for (int i = lo; i < hi; i++)
        render_node(*wc, figs, n_nodes, roots[i]);
      wc->close_run();
    });
  }
  for (auto& t : threads) t.join();
  // stitch in range order: quads append with an index offset, items shift
  for (int w = 0; w < k; w++) {
    Ctx* wc = ctx->workers[w];
    if (wc->count == 0 && wc->items.empty()) continue;
    int off = ctx->count;
    size_t need_f = (size_t)(ctx->count + wc->count) * QF_WIDTH;
    if (ctx->fields.size() < need_f) ctx->fields.resize(need_f * 2, 0.0f);
    size_t need_m = (size_t)(ctx->count + wc->count) * QI_WIDTH;
    if (ctx->modes.size() < need_m) ctx->modes.resize(need_m * 2, 0);
    std::memcpy(&ctx->fields[(size_t)ctx->count * QF_WIDTH], wc->fields.data(),
                (size_t)wc->count * QF_WIDTH * sizeof(float));
    std::memcpy(&ctx->modes[(size_t)ctx->count * QI_WIDTH], wc->modes.data(),
                (size_t)wc->count * QI_WIDTH * sizeof(int32_t));
    ctx->count += wc->count;
    for (const Item& it : wc->items) {
      Item shifted = it;
      if (it.kind == 0) { shifted.start += off; shifted.end += off; }
      ctx->items.push_back(shifted);
    }
    ctx->any_atlas = ctx->any_atlas || wc->any_atlas;
    ctx->any_backdrop = ctx->any_backdrop || wc->any_backdrop;
  }
}

// Append n INERT quad rows: empty bbox (never binned), an inverse affine
// that lands every pixel far outside the uv unit square (u = px - 2e9, so
// `inside` is false and coverage is exactly 0 on both rasterizers — the
// blending identity). Retained scenes reserve per-root rows with these so
// count-changing edits (text labels) can patch in place
// (renderer.snapshot_scene(reserve=...)). Keep bit-identical to
// native.inert_quad_rows (tests/test_retained.py pins the parity).
void fd_pad_rows(Ctx* ctx, int n) {
  for (int i = 0; i < n; i++) {
    int mrd = ctx->ensure_run();
    float* f = ctx->alloc_quad(mrd, /*packed_mode=*/3);
    f[QF_INV_A] = 1.0f;
    f[QF_ORG_X + 0] = 2e9f;
    f[QF_ORG_X + 1] = 2e9f;
    f[QF_BBOX + 0] = 2e9f;
    f[QF_BBOX + 1] = 2e9f;
    f[QF_BBOX + 2] = -2e9f;
    f[QF_BBOX + 3] = -2e9f;
  }
}

// fd_flatten_layer with a per-root quad-span table: spans[i*2] / spans[i*2+1]
// record ctx->count before/after root i's subtree walk. Always serial (the
// span table is the retained-scene update contract — renderer.update_scene
// re-walks only dirty roots and patches their rows in place), byte-identical
// to the serial fd_flatten_layer: recording does not close runs or touch
// walk state.
void fd_flatten_layer_spans(Ctx* ctx, const void* nodes, int n_nodes,
                            const int32_t* roots, int n_roots,
                            int32_t* spans) {
  const Fig* figs = (const Fig*)nodes;
  ctx->merged = false;
  for (int i = 0; i < n_roots; i++) {
    spans[i * 2] = ctx->count;
    render_node(*ctx, figs, n_nodes, roots[i]);
    spans[i * 2 + 1] = ctx->count;
  }
}

// Drawable geometry for subsequent fd_flatten_layer calls: ops are OP_DTYPE
// rows, points a flat (n, 2) f32 control-point pool (nodesarray.py pack_ops).
void fd_set_geometry(Ctx* ctx, const void* ops, int n_ops, const float* points,
                     int n_points) {
  (void)n_ops; (void)n_points;
  ctx->ops = (const DrawOp*)ops;
  ctx->points = points;
}

// Text geometry for subsequent fd_flatten_layer calls (GLYPH_DTYPE /
// TRECT_DTYPE rows from nodesarray.py pack_text).
void fd_set_text_geometry(Ctx* ctx, const void* glyphs, int n_glyphs,
                          const void* trects, int n_trects) {
  (void)n_glyphs; (void)n_trects;
  ctx->glyphs = (const GlyphRow*)glyphs;
  ctx->trects = (const TextRect*)trects;
}

// Runtime text flags (figrender.nim:103-162 runtime toggles).
void fd_set_text_config(Ctx* ctx, int lcd, int subpixel, int variants) {
  ctx->text_lcd = lcd != 0;
  ctx->text_subpixel = subpixel != 0;
  ctx->text_variants = variants != 0;
}

// Glyph raster-origin offsets keyed by glyph hash (sorted ascending).
void fd_set_glyph_offsets(Ctx* ctx, const int64_t* keys, const float* offs,
                          int n) {
  ctx->glyph_off_keys.assign(keys, keys + n);
  ctx->glyph_offs.assign(offs, offs + (size_t)n * 2);
}

int fd_glyph_struct_size() { return (int)sizeof(GlyphRow); }
int fd_trect_struct_size() { return (int)sizeof(TextRect); }

// White-texel uv for bevel/miter join quads (tape.py draw_filled_quad).
void fd_set_white_uv(Ctx* ctx, double u, double v) {
  ctx->white_u = u;
  ctx->white_v = v;
}

// Merge adjacent draw items with the same target whose quad ranges abut —
// the runs one serial walk would have kept open across the parallel walk's
// range boundaries (and across layers, which close_run() split). A no-op
// on serial output: its runs are already maximal (every boundary has a
// blur/clear item between). Keeps fd_export_* bit-identical to the Python
// walk's item list.
static void merge_items(Ctx* ctx) {
  ctx->close_run();
  if (ctx->merged) return;
  ctx->merged = true;
  std::vector<Item>& items = ctx->items;
  // a run's quads all share one mask_read (ensure_run semantics), so the
  // first quad's mask lane identifies it — runs split by a mask-read
  // change must stay split, exactly like the Python walk's items
  auto run_mask = [ctx](const Item& it) {
    return ctx->modes[(size_t)it.start * QI_WIDTH + 1];
  };
  size_t w = 0;
  for (size_t r = 0; r < items.size(); r++) {
    if (w > 0 && items[r].kind == 0 && items[w - 1].kind == 0 &&
        items[r].target == items[w - 1].target &&
        items[r].start == items[w - 1].end &&
        items[r].start < items[r].end &&
        items[w - 1].start < items[w - 1].end &&
        run_mask(items[r]) == run_mask(items[w - 1])) {
      items[w - 1].end = items[r].end;
    } else {
      items[w++] = items[r];
    }
  }
  items.resize(w);
}

// Host-side translucent-stack SATURATION cull (the C++ twin of the device
// tier in figdraw_tpu/ops/binning.py — same conservative cover test, same
// 1/2048 transmittance bound): walk each FRAME-target draw run in reverse
// draw order over a 32x128 pixel cell grid, accumulate the log2
// transmittance of constant-alpha full-cell covers, and DROP a quad when
// every cell its bbox touches is already saturated. The point is the tape
// itself shrinks BEFORE export — on dense scenes (12k boxes = ~28k quads)
// the per-frame host->device upload of ~9 MB is a large share of the
// frame, which no device-side culling can touch. Gated
// to dense tapes so small scenes (every golden) stay byte-exact; runs are
// scoped like the device tier (a later run's covers never erase quads a
// mid-frame backdrop blur still reads).
static const int CULL_MIN_QUADS = 4096;
static const float CULL_LOG2_EPS = -11.0f;  // above-stack transmit < 1/2048
static const int CULL_CELL_H = 32, CULL_CELL_W = 128;

int fd_cull_saturated(Ctx* ctx, float px_w, float px_h) {
  merge_items(ctx);
  if (ctx->count < CULL_MIN_QUADS || px_w <= 0.0f || px_h <= 0.0f) return 0;
  const int cw = (int)((px_w + CULL_CELL_W - 1) / CULL_CELL_W);
  const int ch = (int)((px_h + CULL_CELL_H - 1) / CULL_CELL_H);
  if (cw > 64) return 0;  // sat_rows packs a row per u64 (8192 px wide max)
  std::vector<float> trans((size_t)cw * ch);
  std::vector<uint64_t> sat_rows(ch);  // bit cx set = cell (cy, cx) saturated
  std::vector<uint8_t> drop(ctx->count, 0);
  int dropped = 0;
  for (const Item& it : ctx->items) {
    if (it.kind != 0 || it.target != FRAME_TARGET || it.end <= it.start)
      continue;
    std::fill(trans.begin(), trans.end(), 0.0f);
    std::fill(sat_rows.begin(), sat_rows.end(), 0);
    for (int q = it.end - 1; q >= it.start; q--) {
      const float* f = &ctx->fields[(size_t)q * QF_WIDTH];
      const int32_t* mo = &ctx->modes[(size_t)q * QI_WIDTH];
      const float bx0 = f[QF_BBOX + 0], by0 = f[QF_BBOX + 1];
      const float bx1 = f[QF_BBOX + 2], by1 = f[QF_BBOX + 3];
      // cell c spans [c*W, (c+1)*W): touched iff bx0 < (c+1)*W && bx1 > c*W.
      // Division by the pow2 cell sizes rides exact inverse multiplies.
      constexpr float INV_CW = 1.0f / CULL_CELL_W, INV_CH = 1.0f / CULL_CELL_H;
      int cx0 = std::max(0, (int)std::floor(bx0 * INV_CW));
      int cx1 = std::min(cw - 1, (int)std::ceil(bx1 * INV_CW) - 1);
      int cy0 = std::max(0, (int)std::floor(by0 * INV_CH));
      int cy1 = std::min(ch - 1, (int)std::ceil(by1 * INV_CH) - 1);
      if (cx0 <= cx1 && cy0 <= cy1) {
        // drop test: one AND+CMP per touched row instead of a float scan
        const uint64_t span =
            ((cx1 - cx0 + 1 == 64) ? ~0ull : ((1ull << (cx1 - cx0 + 1)) - 1))
            << cx0;
        bool all_sat = true;
        for (int cy = cy0; cy <= cy1; cy++)
          if ((sat_rows[cy] & span) != span) {
            all_sat = false;
            break;
          }
        if (all_sat) {
          drop[q] = 1;
          dropped++;
          continue;
        }
      }
      // contribute this quad's own coverage (it is above all not-yet-visited
      // quads of the run) — conservative cover test mirroring bin_quads
      const int rest = mo[0] % 256;
      const int fill_mode = mo[0] / 256;
      if (rest % 128 != 3 || mo[1] != 0) continue;           // ClipAA, no mask
      if (f[QF_INV_A + 1] != 0.0f || f[QF_INV_A + 2] != 0.0f) continue;
      if (f[QF_RECT + 2] >= 0.0f) continue;                  // rect mask on
      const bool ell = rest >= 128;
      const float hx = f[QF_PARAMS + 2], hy = f[QF_PARAMS + 3];
      // cover needs 2*ihx >= CELL_W-1 (and ihx < hx since margin > 0):
      // quads smaller than a cell skip the radii decode entirely
      if (hx * 2.0f < CULL_CELL_W - 1.0f || hy * 2.0f < CULL_CELL_H - 1.0f)
        continue;
      float inset_x = 0.0f, inset_y = 0.0f;
      bool radii_ok = true;
      for (int k = 0; k < 4; k++) {
        const float v = f[QF_RADII + k];
        float rx, ry;
        if (ell) {
          if (v < 0.0f) {
            rx = ry = -v - 1.0f;
          } else {
            const float pk = v >= 8388608.0f ? v : std::floor(v + 0.5f);
            rx = std::fmod(pk, 4096.0f) * hx / 4095.0f;
            ry = std::floor(pk / 4096.0f) * hy / 4095.0f;
          }
          if (rx < 0.0f || ry < 0.0f) {
            radii_ok = false;
            break;
          }
        } else {
          if (v < 0.0f) {
            radii_ok = false;
            break;
          }
          rx = ry = v;
        }
        inset_x = std::max(inset_x, rx);
        inset_y = std::max(inset_y, ry);
      }
      if (!radii_ok) continue;
      const float margin = 0.5f / std::max(f[QF_AA], 1e-3f) + 0.01f;
      const float ihx = hx - inset_x - margin;
      const float ihy = hy - inset_y - margin;
      if (ihx <= 0.0f || ihy <= 0.0f) continue;
      // the log2 (and the 4-6 alpha reads feeding it) runs only once a
      // covered cell actually exists — most candidates cover none
      float lt = 0.0f;
      bool lt_ready = false;
      const float ccx = (bx0 + bx1) * 0.5f, ccy = (by0 + by1) * 0.5f;
      for (int cy = cy0; cy <= cy1; cy++) {
        const float t0y = (float)cy * CULL_CELL_H;
        if (!(ccy - ihy <= t0y + 0.5f && ccy + ihy >= t0y + CULL_CELL_H - 0.5f))
          continue;
        for (int cx = cx0; cx <= cx1; cx++) {
          const float t0x = (float)cx * CULL_CELL_W;
          if (ccx - ihx <= t0x + 0.5f &&
              ccx + ihx >= t0x + CULL_CELL_W - 0.5f) {
            if (!lt_ready) {
              float amin =
                  std::min(std::min(f[QF_COLOR0 + 3], f[QF_COLOR0 + 7]),
                           std::min(f[QF_COLOR0 + 11], f[QF_COLOR0 + 15]));
              if (fill_mode != 0)
                amin = std::min(amin, std::min(f[QF_MID + 3], f[QF_STOP + 3]));
              lt = std::log2(
                  std::max(1.0f - amin, 5.9604644775390625e-8f));  // 2^-24
              lt_ready = true;
            }
            float& cell = trans[(size_t)cy * cw + cx];
            cell += lt;
            if (cell < CULL_LOG2_EPS) sat_rows[cy] |= 1ull << cx;
          }
        }
      }
    }
  }
  if (!dropped) return 0;
  // compact: prefix drop counts remap every item's [start, end)
  std::vector<int32_t> pre((size_t)ctx->count + 1, 0);
  for (int q = 0; q < ctx->count; q++) pre[q + 1] = pre[q] + drop[q];
  for (int q = 0; q < ctx->count; q++) {
    if (drop[q]) continue;
    const int dst = q - pre[q];
    if (dst != q) {
      std::memcpy(&ctx->fields[(size_t)dst * QF_WIDTH],
                  &ctx->fields[(size_t)q * QF_WIDTH],
                  QF_WIDTH * sizeof(float));
      std::memcpy(&ctx->modes[(size_t)dst * QI_WIDTH],
                  &ctx->modes[(size_t)q * QI_WIDTH],
                  QI_WIDTH * sizeof(int32_t));
    }
  }
  for (Item& it : ctx->items) {
    if (it.kind != 0) continue;
    it.start -= pre[it.start];
    it.end -= pre[it.end];
  }
  ctx->count -= dropped;
  // drop now-empty draw runs so the pass structure matches a walk that
  // never emitted them
  size_t w = 0;
  for (size_t r = 0; r < ctx->items.size(); r++) {
    if (ctx->items[r].kind == 0 && ctx->items[r].end <= ctx->items[r].start)
      continue;
    ctx->items[w++] = ctx->items[r];
  }
  ctx->items.resize(w);
  return dropped;
}

int fd_quad_count(Ctx* ctx) {
  merge_items(ctx);
  return ctx->count;
}

int fd_item_count(Ctx* ctx) {
  merge_items(ctx);
  return (int)ctx->items.size();
}

// Clear-mask item count: the tight mega-export row bound is
// n_quads + n_clears (each LIVE clear becomes one sentinel row; draw/blur
// items never add rows) — sizing the upload bucket with n_items instead
// wastes up to ~1/3 of the wire on mask-heavy scenes.
int fd_clear_count(Ctx* ctx) {
  merge_items(ctx);
  int n = 0;
  for (const Item& it : ctx->items)
    if (it.kind == 2) n++;
  return n;
}
int fd_mask_count(Ctx* ctx) { return ctx->mask_count; }

// Tape summary for host-side path selection: out = [n_quads, n_items,
// mask_count, flags] with flags bit0 = has blur items, bit1 = any atlas-
// sampling quad, bit2 = any backdrop quad.
void fd_tape_info(Ctx* ctx, int32_t out[4]) {
  merge_items(ctx);
  out[0] = ctx->count;
  out[1] = (int32_t)ctx->items.size();
  out[2] = ctx->mask_count;
  int32_t flags = 0;
  for (const Item& it : ctx->items)
    if (it.kind == 1) { flags |= 1; break; }
  if (ctx->any_atlas) flags |= 2;
  if (ctx->any_backdrop) flags |= 4;
  out[3] = flags;
}

// Exported item kind word: low byte = kind (0 draw, 1 blur, 2 clear-mask);
// draw items carry bit 8 = range contains an atlas-sampling quad and bit 9 =
// range contains a backdrop quad, so the host builds the pass structure
// without rescanning the mode lanes (executor.tape_structure's per-frame
// numpy work).
static int32_t item_kind_word(const Ctx* ctx, const Item& it) {
  int32_t word = it.kind;
  if (it.kind == 0) {
    bool atlas = false, backdrop = false;
    for (int q = it.start; q < it.end && !(atlas && backdrop); q++) {
      int base = ctx->modes[(size_t)q * QI_WIDTH + 0] % 256;
      if (base >= 128) base -= 128;
      if (base == 0 || (base >= 13 && base <= 16)) atlas = true;
      if (base == 17) backdrop = true;
    }
    if (atlas) word |= 1 << 8;
    if (backdrop) word |= 1 << 9;
  }
  return word;
}

// Megakernel combo export (executor.pack_mega_modes in C++): quads in tape
// order with (target+1)<<16 baked into the mode lane, clear-mask sentinels
// spliced in with TIGHT bboxes (union of the quads that read or write the
// plane before its next clear — the clear is a provable no-op elsewhere).
// Each row is row_width floats: QF_WIDTH fields then the two mode lanes
// bit-cast into float slots. Returns rows written, or -1 if rows_cap is too
// small (upper bound: n_quads + n_items).
int fd_export_mega(Ctx* ctx, float* combo, int rows_cap, int row_width) {
  merge_items(ctx);
  const int n = ctx->count;
  if (row_width < QF_WIDTH + 2) return -1;

  // per-quad encoded target (0 = frame, k+1 = mask plane k)
  std::vector<int32_t> tgt(n, 0);
  struct ClearRec { int pos; int plane; float bb[4]; bool live; };
  std::vector<ClearRec> clears;
  {
    int cursor = 0;
    for (const Item& it : ctx->items) {
      if (it.kind == 0) {
        if (it.target >= 0)
          for (int q = it.start; q < it.end; q++) tgt[q] = it.target + 1;
        if (it.end > cursor) cursor = it.end;
      } else if (it.kind == 2) {
        clears.push_back({cursor, it.target, {0, 0, 0, 0}, false});
      }
    }
  }

  // tight bboxes: per plane, one pass over the quads between its clears
  for (int k = 1; k <= ctx->mask_count; k++) {
    std::vector<int> idxs;
    for (size_t c = 0; c < clears.size(); c++)
      if (clears[c].plane == k) idxs.push_back((int)c);
    for (size_t i = 0; i < idxs.size(); i++) {
      ClearRec& cr = clears[idxs[i]];
      int seg_end = (i + 1 < idxs.size()) ? clears[idxs[i + 1]].pos : n;
      double mnx = 1e30, mny = 1e30, mxx = -1e30, mxy = -1e30;
      for (int q = cr.pos; q < seg_end; q++) {
        if (tgt[q] != k + 1 && ctx->modes[(size_t)q * QI_WIDTH + 1] != k)
          continue;
        const float* f = &ctx->fields[(size_t)q * QF_WIDTH];
        mnx = std::fmin(mnx, (double)f[QF_BBOX + 0]);
        mny = std::fmin(mny, (double)f[QF_BBOX + 1]);
        mxx = std::fmax(mxx, (double)f[QF_BBOX + 2]);
        mxy = std::fmax(mxy, (double)f[QF_BBOX + 3]);
      }
      if (mxx > mnx && mxy > mny) {
        cr.live = true;
        cr.bb[0] = (float)mnx; cr.bb[1] = (float)mny;
        cr.bb[2] = (float)mxx; cr.bb[3] = (float)mxy;
      }
    }
  }

  // emission in item order
  int rows = 0;
  size_t ci = 0;
  int cursor = 0;
  auto emit_clear_at = [&](int pos) -> bool {
    while (ci < clears.size() && clears[ci].pos <= pos) {
      const ClearRec& cr = clears[ci];
      if (cr.live) {
        if (rows >= rows_cap) return false;
        float* row = combo + (size_t)rows * row_width;
        std::memset(row, 0, (size_t)row_width * sizeof(float));
        row[QF_BBOX + 0] = cr.bb[0];
        row[QF_BBOX + 1] = cr.bb[1];
        row[QF_BBOX + 2] = cr.bb[2];
        row[QF_BBOX + 3] = cr.bb[3];
        int32_t m = 4096 + ((cr.plane + 1) << 16);  // MEGA_CLEAR_BIT | target
        std::memcpy(&row[QF_WIDTH], &m, 4);
        rows++;
      }
      ci++;
    }
    return true;
  };
  for (const Item& it : ctx->items) {
    if (it.kind == 2) continue;  // handled by position
    if (it.kind != 0) continue;  // blur items invalid here (host gates)
    if (!emit_clear_at(it.start)) return -1;
    for (int q = it.start; q < it.end; q++) {
      if (rows >= rows_cap) return -1;
      float* row = combo + (size_t)rows * row_width;
      std::memcpy(row, &ctx->fields[(size_t)q * QF_WIDTH],
                  QF_WIDTH * sizeof(float));
      int32_t m = ctx->modes[(size_t)q * QI_WIDTH + 0] + (tgt[q] << 16);
      int32_t mk = ctx->modes[(size_t)q * QI_WIDTH + 1];
      std::memcpy(&row[QF_WIDTH], &m, 4);
      std::memcpy(&row[QF_WIDTH + 1], &mk, 4);
      if (row_width > QF_WIDTH + 2)
        std::memset(&row[QF_WIDTH + 2], 0,
                    (size_t)(row_width - QF_WIDTH - 2) * sizeof(float));
      rows++;
    }
    cursor = it.end;
  }
  if (!emit_clear_at(n)) return -1;  // trailing clears
  (void)cursor;
  return rows;
}

// fd_export_mega in the PACKED wire layout (see fd_export_combo_packed):
// quad colors are u8-quantized and clear rows carry zero colors, so mega
// rows pack losslessly too. Mode word (with the baked target bits) and the
// mask lane land in packed cols 50/51.
static void write_packed_quad_row(float* row, const float* f, int32_t m0,
                                  int32_t m1) {
  std::memcpy(row, f, 16 * sizeof(float));
  uint32_t words[6];
  for (int w = 0; w < 6; w++) {
    uint32_t word = 0;
    for (int b = 0; b < 4; b++) {
      const float v = f[QF_COLOR0 + w * 4 + b];
      int k = (int)(v * 255.0f + 0.5f);
      k = k < 0 ? 0 : (k > 255 ? 255 : k);
      word |= (uint32_t)k << (8 * b);
    }
    words[w] = word;
  }
  std::memcpy(&row[16], words, 6 * sizeof(uint32_t));
  std::memcpy(&row[22], &f[QF_PARAMS], 28 * sizeof(float));
  std::memcpy(&row[50], &m0, 4);
  std::memcpy(&row[51], &m1, 4);
}

int fd_export_mega_packed(Ctx* ctx, float* combo, int rows_cap,
                          int row_width) {
  merge_items(ctx);
  const int n = ctx->count;
  if (row_width < 52) return -1;

  std::vector<int32_t> tgt(n, 0);
  struct ClearRec { int pos; int plane; float bb[4]; bool live; };
  std::vector<ClearRec> clears;
  {
    int cursor = 0;
    for (const Item& it : ctx->items) {
      if (it.kind == 0) {
        if (it.target >= 0)
          for (int q = it.start; q < it.end; q++) tgt[q] = it.target + 1;
        if (it.end > cursor) cursor = it.end;
      } else if (it.kind == 2) {
        clears.push_back({cursor, it.target, {0, 0, 0, 0}, false});
      }
    }
  }
  for (int k = 1; k <= ctx->mask_count; k++) {
    std::vector<int> idxs;
    for (size_t c = 0; c < clears.size(); c++)
      if (clears[c].plane == k) idxs.push_back((int)c);
    for (size_t i = 0; i < idxs.size(); i++) {
      ClearRec& cr = clears[idxs[i]];
      int seg_end = (i + 1 < idxs.size()) ? clears[idxs[i + 1]].pos : n;
      double mnx = 1e30, mny = 1e30, mxx = -1e30, mxy = -1e30;
      for (int q = cr.pos; q < seg_end; q++) {
        if (tgt[q] != k + 1 && ctx->modes[(size_t)q * QI_WIDTH + 1] != k)
          continue;
        const float* f = &ctx->fields[(size_t)q * QF_WIDTH];
        mnx = std::fmin(mnx, (double)f[QF_BBOX + 0]);
        mny = std::fmin(mny, (double)f[QF_BBOX + 1]);
        mxx = std::fmax(mxx, (double)f[QF_BBOX + 2]);
        mxy = std::fmax(mxy, (double)f[QF_BBOX + 3]);
      }
      if (mxx > mnx && mxy > mny) {
        cr.live = true;
        cr.bb[0] = (float)mnx; cr.bb[1] = (float)mny;
        cr.bb[2] = (float)mxx; cr.bb[3] = (float)mxy;
      }
    }
  }
  int rows = 0;
  size_t ci = 0;
  auto emit_clear_at = [&](int pos) -> bool {
    while (ci < clears.size() && clears[ci].pos <= pos) {
      const ClearRec& cr = clears[ci];
      if (cr.live) {
        if (rows >= rows_cap) return false;
        float* row = combo + (size_t)rows * row_width;
        std::memset(row, 0, (size_t)row_width * sizeof(float));
        row[QF_BBOX + 0] = cr.bb[0];
        row[QF_BBOX + 1] = cr.bb[1];
        row[QF_BBOX + 2] = cr.bb[2];
        row[QF_BBOX + 3] = cr.bb[3];
        int32_t m = 4096 + ((cr.plane + 1) << 16);  // MEGA_CLEAR_BIT | target
        std::memcpy(&row[50], &m, 4);
        rows++;
      }
      ci++;
    }
    return true;
  };
  for (const Item& it : ctx->items) {
    if (it.kind != 0) continue;
    if (!emit_clear_at(it.start)) return -1;
    for (int q = it.start; q < it.end; q++) {
      if (rows >= rows_cap) return -1;
      float* row = combo + (size_t)rows * row_width;
      if (row_width > 52)
        std::memset(&row[52], 0, (size_t)(row_width - 52) * sizeof(float));
      write_packed_quad_row(
          row, &ctx->fields[(size_t)q * QF_WIDTH],
          ctx->modes[(size_t)q * QI_WIDTH + 0] + (tgt[q] << 16),
          ctx->modes[(size_t)q * QI_WIDTH + 1]);
      rows++;
    }
  }
  if (!emit_clear_at(n)) return -1;  // trailing clears
  // zero the padding rows so pooled (reused) upload buffers never carry a
  // previous frame's quads — padding must stay inert (empty bboxes)
  if (rows < rows_cap)
    std::memset(combo + (size_t)rows * row_width, 0,
                (size_t)(rows_cap - rows) * row_width * sizeof(float));
  return rows;
}

// Items only (kind, target, start, end, radius-bits) — lets the host build
// the pass structure and meta layout BEFORE sizing the upload buffer.
int fd_export_items(Ctx* ctx, int32_t* items, int item_cap) {
  merge_items(ctx);
  if ((int)ctx->items.size() > item_cap) return -1;
  for (size_t i = 0; i < ctx->items.size(); i++) {
    const Item& it = ctx->items[i];
    items[i * 5 + 0] = item_kind_word(ctx, it);
    items[i * 5 + 1] = it.target;
    items[i * 5 + 2] = it.start;
    items[i * 5 + 3] = it.end;
    std::memcpy(&items[i * 5 + 4], &it.radius, 4);
  }
  return (int)ctx->items.size();
}

// Quad rows straight into an upload combo buffer: row_width floats per row,
// QF_WIDTH field lanes then the two bitcast i32 mode lanes. The host
// allocates (n_pad + meta_rows) zeroed rows and fills the meta tail itself.
// Returns the quad count, or -1 if rows_cap < count.
int fd_export_combo(Ctx* ctx, float* combo, int rows_cap, int row_width) {
  merge_items(ctx);
  if (row_width < QF_WIDTH + QI_WIDTH || ctx->count > rows_cap) return -1;
  for (int q = 0; q < ctx->count; q++) {
    float* row = combo + (size_t)q * row_width;
    std::memcpy(row, &ctx->fields[(size_t)q * QF_WIDTH],
                QF_WIDTH * sizeof(float));
    std::memcpy(&row[QF_WIDTH], &ctx->modes[(size_t)q * QI_WIDTH],
                QI_WIDTH * sizeof(int32_t));
  }
  return ctx->count;
}

// PACKED combo export — the upload wire format. Every tape color is
// u8-quantized (emit_quad writes c/255.0f), so the 24 color floats
// (4 vertices + mid + stop, RGBA) round-trip EXACTLY through one byte
// each: 6 u32 words bitcast into float lanes. Row layout (52 wide):
//   [0:16)  fields cols 0..15 (inv, org, bbox, uv3, uvdu, uvdv)
//   [16:22) 6 color words, little-endian bytes in field-column order
//   [22:50) fields cols 40..67 (params, radii, factors, aa, subpix, rect)
//   [50:52) mode lanes (i32 bitcast)
// The executor unpacks on device (k/255.0f is the same IEEE op the walk
// performed, so the logical tape is bit-identical); the wire shrinks 26%.
int fd_export_combo_packed(Ctx* ctx, float* combo, int rows_cap,
                           int row_width) {
  merge_items(ctx);
  if (row_width < 52 || ctx->count > rows_cap) return -1;
  for (int q = 0; q < ctx->count; q++) {
    write_packed_quad_row(combo + (size_t)q * row_width,
                          &ctx->fields[(size_t)q * QF_WIDTH],
                          ctx->modes[(size_t)q * QI_WIDTH + 0],
                          ctx->modes[(size_t)q * QI_WIDTH + 1]);
  }
  return ctx->count;
}

int fd_fig_struct_size() { return (int)sizeof(Fig); }
int fd_op_struct_size() { return (int)sizeof(DrawOp); }

// ==== border op generators (figdraw_tpu/borders.py, bit-identical) ===========
// The reference exports figRoundedRectBorder / figDashedRoundedRectBorder /
// figDottedRoundedRectBorder over its ABI (utils/drawutils.nim:351-404
// {.nativeAbi.}); fd_border_ops emits the same DrawOp rows a C host feeds
// into fd_renders_add_op. All path math in double like Python, f32 stores.

namespace {

constexpr double kPathEps = 1e-6;

struct BSeg {
  int kind;  // 0 line, 1 arc
  double length;
  double ax, ay, bx, by;           // line
  double cx, cy, radius, a0, swp;  // arc
};

double positive_mod(double v, double cycle) {
  if (cycle <= kPathEps) return 0.0;
  double r = v - std::floor(v / cycle) * cycle;
  if (r < 0.0) r += cycle;
  return r;
}

void border_segments(double x, double y, double w, double h,
                     const double *corners, std::vector<BSeg> &out) {
  if (w <= 0.0 || h <= 0.0) return;
  double max_radius = std::max(0.0, std::min(w, h) * 0.5);
  double r[4];  // TL, TR, BL, BR
  for (int k = 0; k < 4; k++) r[k] = std::min(corners[k], max_radius);
  double scale = 1.0;
  const double pairs[4][2] = {{r[0] + r[1], w},
                              {r[2] + r[3], w},
                              {r[0] + r[2], h},
                              {r[1] + r[3], h}};
  for (auto &pe : pairs)
    if (pe[0] > kPathEps) scale = std::min(scale, pe[1] / pe[0]);
  if (scale < 1.0)
    for (int k = 0; k < 4; k++) r[k] *= scale;
  double tl = r[0], tr = r[1], bl = r[2], br = r[3];
  double x0 = x, y0 = y, x1 = x + w, y1 = y + h;
  const double quarter = M_PI * 0.5;
  auto add_line = [&](double ax, double ay, double bx, double by) {
    double dx = bx - ax, dy = by - ay;
    double length = std::sqrt(dx * dx + dy * dy);
    if (length > kPathEps)
      out.push_back({0, length, ax, ay, bx, by, 0, 0, 0, 0, 0});
  };
  auto add_arc = [&](double cx, double cy, double radius, double start,
                     double sweep) {
    double length = std::fabs(radius * sweep);
    if (radius > kPathEps && length > kPathEps)
      out.push_back({1, length, 0, 0, 0, 0, cx, cy, radius, start, sweep});
  };
  add_line(x0 + tl, y0, x1 - tr, y0);
  add_arc(x1 - tr, y0 + tr, tr, -quarter, quarter);
  add_line(x1, y0 + tr, x1, y1 - br);
  add_arc(x1 - br, y1 - br, br, 0.0, quarter);
  add_line(x1 - br, y1, x0 + bl, y1);
  add_arc(x0 + bl, y1 - bl, bl, quarter, quarter);
  add_line(x0, y1 - bl, x0, y0 + tl);
  add_arc(x0 + tl, y0 + tl, tl, M_PI, quarter);
}

void emit_op(DrawOp *ops, int cap, int &count, const DrawOp &op) {
  if (count < cap && ops) ops[count] = op;
  count++;
}

DrawOp line_op(double ax, double ay, double bx, double by) {
  DrawOp op{};
  op.kind = DK_LINE;
  op.data[0] = (float)ax;
  op.data[1] = (float)ay;
  op.data[2] = (float)bx;
  op.data[3] = (float)by;
  return op;
}

DrawOp arc_op(double cx, double cy, double r, double a0, double sweep) {
  DrawOp op{};
  op.kind = DK_ARC;
  op.data[0] = (float)cx;
  op.data[1] = (float)cy;
  op.data[2] = (float)r;
  op.data[3] = (float)a0;
  op.data[4] = (float)sweep;
  return op;
}

// borders._add_interval: clip [start, stop) of path arc-length onto each
// segment, emitting partial lines/arcs
void add_interval(DrawOp *ops, int cap, int &count,
                  const std::vector<BSeg> &segs, double start, double stop) {
  double seg_start = 0.0;
  for (const BSeg &seg : segs) {
    double seg_stop = seg_start + seg.length;
    double local_start = std::max(start, seg_start);
    double local_stop = std::min(stop, seg_stop);
    if (local_stop > local_start + kPathEps) {
      double s = local_start - seg_start, e = local_stop - seg_start;
      double t0 = s / seg.length, t1 = e / seg.length;
      if (seg.kind == 0)
        emit_op(ops, cap, count,
                line_op(seg.ax + (seg.bx - seg.ax) * t0,
                        seg.ay + (seg.by - seg.ay) * t0,
                        seg.ax + (seg.bx - seg.ax) * t1,
                        seg.ay + (seg.by - seg.ay) * t1));
      else
        emit_op(ops, cap, count,
                arc_op(seg.cx, seg.cy, seg.radius, seg.a0 + seg.swp * t0,
                       seg.swp * (t1 - t0)));
    }
    seg_start = seg_stop;
  }
}

// borders._point_at
void point_at(const std::vector<BSeg> &segs, double distance, double *px,
              double *py) {
  double seg_start = 0.0;
  for (const BSeg &seg : segs) {
    double seg_stop = seg_start + seg.length;
    if (distance <= seg_stop + kPathEps) {
      double local =
          std::min(std::max(distance - seg_start, 0.0), seg.length);
      if (seg.kind == 0) {
        double t = local / seg.length;
        *px = seg.ax + (seg.bx - seg.ax) * t;
        *py = seg.ay + (seg.by - seg.ay) * t;
      } else {
        double angle = seg.a0 + seg.swp * (local / seg.length);
        *px = seg.cx + std::cos(angle) * seg.radius;
        *py = seg.cy + std::sin(angle) * seg.radius;
      }
      return;
    }
    seg_start = seg_stop;
  }
  *px = 0.0;
  *py = 0.0;
}

int solid_border_ops(const std::vector<BSeg> &segs, DrawOp *ops, int cap) {
  int count = 0;
  for (const BSeg &seg : segs) {
    if (seg.kind == 0)
      emit_op(ops, cap, count, line_op(seg.ax, seg.ay, seg.bx, seg.by));
    else
      emit_op(ops, cap, count,
              arc_op(seg.cx, seg.cy, seg.radius, seg.a0, seg.swp));
  }
  return count;
}

}  // namespace

// style: 0 solid, 1 dashed (p1 dash length, p2 gap), 2 dotted (p1 dot
// radius, p2 gap). corners = {TL, TR, BL, BR}. Writes up to cap DrawOp rows
// and returns the TOTAL count (call again with a larger buffer if > cap).
int fd_border_ops(int style, double bx, double by, double bw, double bh,
                  const double *corners, double p1, double p2, double offset,
                  DrawOp *ops, int cap) {
  std::vector<BSeg> segs;
  border_segments(bx, by, bw, bh, corners, segs);
  if (style == 0) return solid_border_ops(segs, ops, cap);
  double path_length = 0.0;
  for (const BSeg &s : segs) path_length += s.length;
  int count = 0;
  if (style == 1) {  // dashed (borders.py drawable_dashed_*)
    double dash = p1, gap = p2;  // already double — Python parity
    if (dash <= kPathEps) return 0;
    if (gap <= kPathEps) return solid_border_ops(segs, ops, cap);
    double cycle = dash + gap;
    if (path_length <= kPathEps || cycle <= kPathEps) return 0;
    double distance = 0.0;
    double phase = positive_mod(offset, cycle);
    bool drawing = phase < dash;
    double run_remaining = drawing ? dash - phase : cycle - phase;
    while (distance < path_length - kPathEps) {
      double run_stop = std::min(path_length, distance + run_remaining);
      if (drawing) add_interval(ops, cap, count, segs, distance, run_stop);
      distance = run_stop;
      drawing = !drawing;
      run_remaining = drawing ? dash : gap;
    }
    return count;
  }
  if (style == 2) {  // dotted
    double dot = p1, gap = std::max(0.0, p2);
    if (dot <= kPathEps) return 0;
    double spacing = dot * 2.0 + gap;
    if (path_length <= kPathEps || spacing <= kPathEps) return 0;
    double phase = positive_mod(offset, spacing);
    double distance = phase <= kPathEps ? 0.0 : spacing - phase;
    while (distance < path_length - kPathEps) {
      double px, py;
      point_at(segs, distance, &px, &py);
      DrawOp op{};
      op.kind = DK_CIRCLE;
      op.data[0] = (float)px;
      op.data[1] = (float)py;
      op.data[2] = (float)dot;
      emit_op(ops, cap, count, op);
      distance += spacing;
    }
    return count;
  }
  return 0;
}

// Export: fields (cap, QF_WIDTH) f32, modes (cap, QI_WIDTH) i32,
// items (n, 5) i32 with radius bit-cast in slot 4.
int fd_export(Ctx* ctx, float* fields, int32_t* modes, int quad_cap,
              int32_t* items, int item_cap) {
  merge_items(ctx);
  if (ctx->count > quad_cap || (int)ctx->items.size() > item_cap) return -1;
  std::memcpy(fields, ctx->fields.data(),
              (size_t)ctx->count * QF_WIDTH * sizeof(float));
  std::memcpy(modes, ctx->modes.data(),
              (size_t)ctx->count * QI_WIDTH * sizeof(int32_t));
  for (size_t i = 0; i < ctx->items.size(); i++) {
    const Item& it = ctx->items[i];
    items[i * 5 + 0] = item_kind_word(ctx, it);
    items[i * 5 + 1] = it.target;
    items[i * 5 + 2] = it.start;
    items[i * 5 + 3] = it.end;
    std::memcpy(&items[i * 5 + 4], &it.radius, 4);
  }
  return ctx->count;
}

// ---- retained-scene C API ---------------------------------------------------
//
// The C-host analog of renderer.snapshot_scene / update_scene (the reference
// exports retained editing over its dynlib the same way,
// bindings/native_bindings.nim updateNode consumers): flatten once recording
// per-root spans, keep the exported rows, then after an edit re-walk ONLY the
// dirty root in a scratch context and splice its rows over the old span.
// docs/native_api.md walks the full recipe; native/examples/scene_demo.c
// exercises it end-to-end.

// Total root count across layers — the span-table size for
// fd_flatten_renders_spans (one [start, end) pair per root, flatten order:
// layers ascending zlevel, then layer root order).
int fd_renders_root_count(FdRenders* r) {
  int n = 0;
  for (const FdLayer& l : r->layers) n += (int)l.roots.size();
  return n;
}

// Overwrite node `index` of layer `zlevel` in place — the retained-edit
// mutation (fills, boxes, corners, rotation). The tree-management fields the
// add calls own (zlevel, parent, child_count) are preserved; everything else
// is replaced. Returns 0, or -1 on an unknown layer / bad index.
int fd_renders_set_fig(FdRenders* r, int zlevel, int index, const void* fig) {
  for (FdLayer& l : r->layers) {
    if ((int)l.zlevel != zlevel) continue;
    if (index < 0 || index >= (int)l.nodes.size()) return -1;
    Fig& dst = l.nodes[index];
    const int8_t zl = dst.zlevel;
    const int16_t parent = dst.parent;
    const int16_t child_count = dst.child_count;
    std::memcpy(&dst, fig, sizeof(Fig));
    dst.zlevel = zl;
    dst.parent = parent;
    dst.child_count = child_count;
    return 0;
  }
  return -1;
}

// fd_flatten_renders recording per-root quad spans: spans[i*2]/spans[i*2+1]
// hold the tape row range root i's subtree emitted (flatten order), INCLUDING
// `reserve` trailing inert rows (fd_pad_rows) appended after every root so
// count-growing edits can patch in place — the C analog of
// renderer.snapshot_scene(reserve=...). Always a serial walk (the span table
// is the retained-update contract); apart from the pads the tape is
// byte-identical to fd_flatten_renders. Returns the root count, or -1 if
// spans_cap holds fewer pairs.
int fd_flatten_renders_spans(Ctx* ctx, FdRenders* r, int32_t* spans,
                             int spans_cap, int reserve) {
  const int n_roots = fd_renders_root_count(r);
  if (spans_cap < n_roots) return -1;
  int i = 0;
  for (FdLayer& l : r->layers) {
    ctx->ops = l.ops.empty() ? nullptr : l.ops.data();
    ctx->points = l.points.empty() ? nullptr : l.points.data();
    ctx->glyphs = l.glyphs.empty() ? nullptr : l.glyphs.data();
    ctx->trects = l.trects.empty() ? nullptr : l.trects.data();
    ctx->merged = false;
    for (int32_t root : l.roots) {
      spans[i * 2] = ctx->count;
      render_node(*ctx, l.nodes.data(), (int)l.nodes.size(), root);
      if (reserve > 0) fd_pad_rows(ctx, reserve);
      spans[i * 2 + 1] = ctx->count;
      i++;
    }
  }
  ctx->ops = nullptr;
  ctx->points = nullptr;
  ctx->glyphs = nullptr;
  ctx->trects = nullptr;
  return n_roots;
}

// Re-walk ONE root subtree — layer `zlevel`, root position `root_pos` in that
// layer's root order — appending its quads to `ctx`: the retained-edit patch
// walk, run on a fresh/reset scratch context configured like the snapshot
// walk (same fd_set_atlas / fd_set_glyph_offsets / fd_set_white_uv /
// fd_set_text_config; layer geometry comes from `r` here). The rows are
// byte-identical to that root's segment of fd_flatten_renders PROVIDED the
// subtree emits no mask planes, blur, or backdrop items (mask numbering and
// pass structure are context-global): verify fd_mask_count(scratch) == 0 and
// fd_item_count(scratch) <= 1 after the walk, else re-flatten everything —
// the same downgrade rule renderer.update_scene applies. Returns the quad
// count emitted, or -1 on an unknown layer / bad root position.
int fd_flatten_renders_root(Ctx* ctx, FdRenders* r, int zlevel, int root_pos) {
  for (FdLayer& l : r->layers) {
    if ((int)l.zlevel != zlevel) continue;
    if (root_pos < 0 || root_pos >= (int)l.roots.size()) return -1;
    ctx->ops = l.ops.empty() ? nullptr : l.ops.data();
    ctx->points = l.points.empty() ? nullptr : l.points.data();
    ctx->glyphs = l.glyphs.empty() ? nullptr : l.glyphs.data();
    ctx->trects = l.trects.empty() ? nullptr : l.trects.data();
    ctx->merged = false;
    const int before = ctx->count;
    render_node(*ctx, l.nodes.data(), (int)l.nodes.size(),
                l.roots[root_pos]);
    ctx->ops = nullptr;
    ctx->points = nullptr;
    ctx->glyphs = nullptr;
    ctx->trects = nullptr;
    return ctx->count - before;
  }
  return -1;
}

// ---- demo-scene animator ----------------------------------------------------
//
// The per-frame column writer of the 300-box benchmark scene
// (figdraw_tpu/scenes.py _scene_animate_np is the semantic reference — the
// reference's renderlist_100_common.nim animates in compiled Nim, so the
// host side of the frame loop is native there too). Must stay BIT-identical
// to the numpy path (tests/test_scenes_native.py): all math in double in
// the same operation order, f64->f32 stores round-to-nearest like numpy
// assignment, f64->u16 corner stores truncate toward zero like numpy
// casting. Built with -ffp-contract=off (native.py) so no FMA re-rounding
// diverges from numpy, which never contracts.
//
// Phase tables are the Python-side caches (_scene_anim_state): sin/cos of
// the per-copy phase offsets, (9, copies) and (7, copies) row-major. Per
// frame only the 32 t-dependent scalars hit libm; each copy's phase value
// is an angle-addition mul/mul/add.
int fd_scene_animate(Fig* nodes, int32_t count, double w, double h,
                     double clamp_x, double clamp_y,
                     int32_t frame, int32_t copies,
                     const double* base_xs, const double* base_ys,
                     const double* sin_of_sp, const double* cos_of_sp,
                     const double* sin_of_cp, const double* cos_of_cp,
                     const double* sin_t, const double* cos_t) {
  if (count < 1 + 3 * copies + 3) return -1;
  const double t = (double)frame * 0.02;
  double sin_ta[9], cos_ta[9], sin_tc[7], cos_tc[7];
  for (int k = 0; k < 9; k++) {
    sin_ta[k] = std::sin(t * sin_t[k]);
    cos_ta[k] = std::cos(t * sin_t[k]);
  }
  for (int k = 0; k < 7; k++) {
    sin_tc[k] = std::sin(t * cos_t[k]);
    cos_tc[k] = std::cos(t * cos_t[k]);
  }
  // clamp_x/clamp_y come from the Python dispatcher (scenes.py
  // _SCENE_CLAMP_X/_SCENE_CLAMP_Y — box-column start + max animated size):
  // one source of truth instead of a comment-enforced constant pairing
  const double max_x = w - clamp_x > 0.0 ? w - clamp_x : 0.0;
  const double max_y = h - clamp_y > 0.0 ? h - clamp_y : 0.0;

  for (int32_t i = 0; i < copies; i++) {
    double s[9], c[7];
    for (int k = 0; k < 9; k++) {
      const int32_t idx = k * copies + i;
      s[k] = cos_of_sp[idx] * sin_ta[k] + sin_of_sp[idx] * cos_ta[k];
    }
    for (int k = 0; k < 7; k++) {
      const int32_t idx = k * copies + i;
      c[k] = cos_of_cp[idx] * cos_tc[k] - sin_of_cp[idx] * sin_tc[k];
    }
    double off_x = base_xs[i] + s[0] * 20.0;
    off_x = off_x < 0.0 ? 0.0 : (off_x > max_x ? max_x : off_x);
    double off_y = base_ys[i] + c[0] * 20.0;
    off_y = off_y < 0.0 ? 0.0 : (off_y > max_y ? max_y : off_y);
    const double pulse_w = 0.5 + 0.5 * s[1];
    const double pulse_h = 0.5 + 0.5 * c[1];

    // red: elliptical corner animation
    Fig& r = nodes[1 + 3 * i];
    r.box[0] = (float)(60.0 + off_x);
    r.box[1] = (float)(60.0 + off_y);
    r.box[2] = (float)(160.0 + 100.0 * pulse_w);
    r.box[3] = (float)(110.0 + 70.0 * pulse_h);
    const double cp = 0.5 + 0.5 * s[2];
    const double c0f = 4.0 + 26.0 * cp;
    const double c1f = 6.0 + 22.0 * (1.0 - cp);
    const double c2f = 8.0 + 18.0 * (0.5 + 0.5 * s[3]);
    const double c3f = 10.0 + 16.0 * (0.5 + 0.5 * c[2]);
    r.corners[0] = (uint16_t)c0f;
    r.corners[1] = (uint16_t)c1f;
    r.corners[2] = (uint16_t)c2f;
    r.corners[3] = (uint16_t)c3f;
    r.corners_y[0] = (uint16_t)c0f;
    r.corners_y[1] = (uint16_t)(c1f * 2.0);
    r.corners_y[2] = (uint16_t)c2f;
    r.corners_y[3] = (uint16_t)(c3f * 2.0);

    // green: box, corners, drop shadow animation
    Fig& g = nodes[2 + 3 * i];
    g.box[0] = (float)(320.0 + off_x);
    g.box[1] = (float)(120.0 + off_y);
    g.box[2] = (float)(160.0 + 100.0 * pulse_h);
    g.box[3] = (float)(110.0 + 70.0 * pulse_w);
    const double gp = 0.5 + 0.5 * c[3];
    g.corners[0] = (uint16_t)(6.0 + 22.0 * gp);
    g.corners[1] = (uint16_t)(8.0 + 18.0 * (1.0 - gp));
    g.corners[2] = (uint16_t)(10.0 + 16.0 * (0.5 + 0.5 * c[4]));
    g.corners[3] = (uint16_t)(12.0 + 14.0 * (0.5 + 0.5 * s[4]));
    const double sp = 0.5 + 0.5 * s[5];
    const double gblur = 6.0 + 18.0 * sp;
    const double gspread = 4.0 + 20.0 * (1.0 - sp);
    g.shadows[0].blur = (float)(gblur > 0.0 ? gblur : 0.0);
    g.shadows[0].spread = (float)(gspread > 0.0 ? gspread : 0.0);
    g.shadows[0].x = (float)(6.0 + 10.0 * s[6]);
    g.shadows[0].y = (float)(6.0 + 10.0 * c[5]);

    // blue: box + inner shadow animation
    Fig& b = nodes[3 + 3 * i];
    b.box[0] = (float)(180.0 + off_x);
    b.box[1] = (float)(300.0 + off_y);
    b.box[2] = (float)(160.0 + 100.0 * (1.0 - pulse_w));
    b.box[3] = (float)(110.0 + 70.0 * (1.0 - pulse_h));
    const double ip = 0.5 + 0.5 * s[7];
    const double bblur = 8.0 + 10.0 * ip;
    const double bspread = 2.0 + 10.0 * (1.0 - ip);
    b.shadows[0].blur = (float)(bblur > 0.0 ? bblur : 0.0);
    b.shadows[0].spread = (float)(bspread > 0.0 ? bspread : 0.0);
    b.shadows[0].x = (float)(6.0 * s[8]);
    b.shadows[0].y = (float)(6.0 * c[6]);
  }

  // moving blur panel + overlay
  const int32_t base = 1 + 3 * copies;
  const double yw = 360.0, yh = 240.0, ym = 20.0;
  const double span_x = w - yw - ym * 2.0, span_y = h - yh - ym * 2.0;
  const double yx =
      ym + (span_x > 0.0 ? span_x : 0.0) * (0.5 + 0.5 * std::sin(t * 0.33));
  const double yy =
      ym + (span_y > 0.0 ? span_y : 0.0) * (0.5 + 0.5 * std::cos(t * 0.41));
  const uint16_t yc =
      (uint16_t)(20.0 + 12.0 * (0.5 + 0.5 * std::sin(t * 0.7)));
  for (int32_t n = base + 1; n <= base + 2; n++) {
    nodes[n].box[0] = (float)yx;
    nodes[n].box[1] = (float)yy;
    nodes[n].box[2] = (float)yw;
    nodes[n].box[3] = (float)yh;
    for (int k = 0; k < 4; k++) nodes[n].corners[k] = yc;
  }
  return 0;
}

}  // extern "C"
