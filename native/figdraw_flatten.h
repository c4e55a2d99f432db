/* C ABI of the figdraw_tpu native flattener (libfigdraw_flatten.so).
 *
 * The native-integration surface of the engine, counterpart of the
 * reference's C-ABI dynlib facade (bindings/native_bindings.nim +
 * native_dynlib.json): external hosts build scenes as packed Fig rows
 * (layout mirrored by figdraw_tpu/nodesarray.py FIG_DTYPE, validated at load
 * time via fd_fig_struct_size) and receive the packed quad tape + pass items
 * that the device executor consumes.
 *
 * Quad record layout: figdraw_tpu/ops/layout.py (QF_* / QI_* offsets).
 * Item rows (5 x int32): kind word (low byte 0 draw, 1 blur, 2 clear-mask;
 * draw items carry bit 8 = range samples the atlas, bit 9 = range holds a
 * backdrop quad), target (-1 frame / mask index), start, end, radius
 * (float bits in slot 4).
 */

#ifndef FIGDRAW_FLATTEN_H
#define FIGDRAW_FLATTEN_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct FigdrawFlattenCtx FigdrawFlattenCtx;

/* Create a flatten context. ui_scale/pixel_scale mirror setFigUiScale and
 * the renderer pixel scale; aa_factor is the SDF coverage slope (1.2). */
FigdrawFlattenCtx *fd_create(float ui_scale, float pixel_scale, float aa_factor);
void fd_destroy(FigdrawFlattenCtx *ctx);

/* Reset a context for a fresh walk (keeps vector capacity across frames;
 * drops atlas entries / glyph offsets / text config so stale state cannot
 * leak into the next scene — re-set them after). */
void fd_reset(FigdrawFlattenCtx *ctx, float ui_scale, float pixel_scale,
              float aa_factor);

/* Walk one layer's roots in order. nodes: n_nodes packed Fig rows;
 * roots: indexes into nodes. Call once per layer in ascending ZLevel. */
void fd_flatten_layer(FigdrawFlattenCtx *ctx, const void *nodes, int n_nodes,
                      const int32_t *roots, int n_roots);

/* fd_flatten_layer recording per-root quad spans: spans[i*2]/spans[i*2+1]
 * hold the tape row range root i's subtree emitted (the retained-scene
 * update contract; always a serial walk, byte-identical output). */
void fd_flatten_layer_spans(FigdrawFlattenCtx *ctx, const void *nodes,
                            int n_nodes, const int32_t *roots, int n_roots,
                            int32_t *spans);

/* Append n inert quad rows (coverage exactly 0 everywhere, never binned):
 * retained-scene row reserves for count-changing in-place edits. */
void fd_pad_rows(FigdrawFlattenCtx *ctx, int n);

/* Drawable geometry for subsequent fd_flatten_layer calls: ops are n_ops
 * packed DrawOp rows (OP_DTYPE), points a flat n_points x 2 float control
 * pool referenced by bezier ops. Set per layer; pointers must stay valid
 * through the fd_flatten_layer call. */
void fd_set_geometry(FigdrawFlattenCtx *ctx, const void *ops, int n_ops,
                     const float *points, int n_points);

/* White-texel uv (atlas-normalized) used by bevel/miter join quads. */
void fd_set_white_uv(FigdrawFlattenCtx *ctx, double u, double v);

/* Result sizes (call after the last layer). */
int fd_quad_count(FigdrawFlattenCtx *ctx);
int fd_item_count(FigdrawFlattenCtx *ctx);
int fd_mask_count(FigdrawFlattenCtx *ctx);
int fd_clear_count(FigdrawFlattenCtx *ctx); /* clear-mask items only */

/* Size of one packed Fig row; must equal FIG_DTYPE.itemsize (336). */
int fd_fig_struct_size(void);

/* Size of one packed DrawOp row; must equal OP_DTYPE.itemsize (48). */
int fd_op_struct_size(void);

/* Border op generators — the reference's figRoundedRectBorder /
 * figDashedRoundedRectBorder / figDottedRoundedRectBorder ABI exports
 * (utils/drawutils.nim:351-404): emit the DrawOp rows (fd_op_struct_size()
 * bytes each, OP_DTYPE) of a rounded-rect border perimeter for
 * fd_renders_add_op, bit-identical to figdraw_tpu/borders.py. style:
 * 0 solid, 1 dashed (p1 = dash length, p2 = gap length), 2 dotted
 * (p1 = dot radius, p2 = edge-to-edge gap); offset phases the pattern
 * along the path. corners = {TL, TR, BL, BR} px. Returns the TOTAL op
 * count — call again with a larger buffer when it exceeds cap. All
 * params are double: the generators must be bit-identical to borders.py,
 * whose inputs are Python doubles. */
int fd_border_ops(int style, double x, double y, double w, double h,
                  const double *corners, double p1, double p2, double offset,
                  void *ops, int cap);

/* Copy out quads and items; returns the quad count or -1 if a capacity is
 * too small. fields: quad_cap x 68 floats; modes: quad_cap x 2 int32;
 * items: item_cap x 5 int32. */
int fd_export(FigdrawFlattenCtx *ctx, float *fields, int32_t *modes,
              int quad_cap, int32_t *items, int item_cap);

/* Pass items only (n, 5) i32 — size the upload buffer before exporting. */
int fd_export_items(FigdrawFlattenCtx *ctx, int32_t *items, int item_cap);

/* Quad rows straight into an upload buffer: rows_cap rows of row_width
 * floats (68 field lanes + 2 bitcast i32 mode lanes); the caller fills the
 * meta tail. Returns the quad count, -1 on overflow. */
int fd_export_combo(FigdrawFlattenCtx *ctx, float *combo, int rows_cap,
                    int row_width);

/* ---- scene-building API (native_bindings.nim analog) ----------------------
 *
 * External hosts build layered render lists directly in C: fill packed Fig
 * rows (fd_fig_struct_size() bytes, layout = nodesarray.py FIG_DTYPE) and
 * DrawOp rows (fd_op_struct_size() bytes, OP_DTYPE), append them with the
 * same O(1) addRoot/addChild semantics as fignodes.nim:316-374, then flatten
 * every layer in ascending zlevel with one call and export the quad tape. */

typedef struct FdRenders FdRenders;

FdRenders *fd_renders_new(void);
void fd_renders_free(FdRenders *renders);

/* Append a root / a child of `parent`; returns the node index in its layer
 * (children must be appended after their parent). add_child returns -1 on a
 * bad parent index. The row's zlevel/parent/child_count fields are managed
 * by these calls; fill everything else before appending. */
int fd_renders_add_root(FdRenders *renders, int zlevel, const void *fig);
int fd_renders_add_child(FdRenders *renders, int zlevel, int parent,
                         const void *fig);

/* Drawable geometry: read the layer's current op count into Fig.ops_start,
 * append that node's ops, set Fig.ops_count, then add the node. For bezier
 * ops pass `pts` as n_pts (x, y) pairs — p_start is rewritten to the layer
 * point pool. Returns the op index. */
int fd_renders_op_count(FdRenders *renders, int zlevel);
int fd_renders_add_op(FdRenders *renders, int zlevel, const void *op,
                      const float *pts, int n_pts);

/* Text geometry for nkText nodes: pre-shaped glyph rows
 * (fd_glyph_struct_size() bytes each, layout = nodesarray.py GLYPH_DTYPE)
 * and selection/decoration rects (fd_trect_struct_size(), TRECT_DTYPE).
 * Same pattern as ops: read the layer's current counts into the node's
 * glyphs_start / trects_start, append the rows, set the counts, then add
 * the node. Glyph atlas entries + raster origin offsets come from
 * fd_set_atlas / fd_set_glyph_offsets on the flatten context. */
int fd_renders_glyph_count(FdRenders *renders, int zlevel);
int fd_renders_trect_count(FdRenders *renders, int zlevel);
int fd_renders_add_text(FdRenders *renders, int zlevel, const void *glyphs,
                        int n_glyphs, const void *trects, int n_trects);

/* Flatten every layer (ascending zlevel) into the context's tape. */
void fd_flatten_renders(FigdrawFlattenCtx *ctx, FdRenders *renders);

/* ---- retained editing (snapshot_scene / update_scene analog) ---------------
 *
 * Recipe (docs/native_api.md has the full walkthrough; scene_demo.c runs it):
 *   1. fd_flatten_renders_spans records each root's tape row span (+reserve
 *      inert pad rows for count-growing edits); export and keep the rows.
 *   2. Edit nodes in place with fd_renders_set_fig.
 *   3. Re-walk ONLY the dirty root with fd_flatten_renders_root on a reset
 *      scratch context (same atlas/white-uv/text config as the snapshot
 *      walk), export its rows, fd_pad_rows the shortfall up to the span
 *      length, and splice them over the old span — byte-identical to a full
 *      re-flatten PROVIDED the dirty subtree emits no masks/blur/backdrop
 *      (check fd_mask_count(scratch) == 0 and fd_item_count(scratch) <= 1,
 *      else fall back to a full re-flatten). */

/* Total root count across layers — the span-table size (one pair per root,
 * flatten order: layers ascending zlevel, then layer root order). */
int fd_renders_root_count(FdRenders *renders);

/* Overwrite node `index` of layer `zlevel` in place (zlevel/parent/
 * child_count are preserved). Returns 0, or -1 on a bad layer/index. */
int fd_renders_set_fig(FdRenders *renders, int zlevel, int index,
                       const void *fig);

/* fd_flatten_renders recording per-root spans into spans[i*2..i*2+1],
 * each padded with `reserve` trailing inert rows. Returns the root count,
 * or -1 if spans_cap holds fewer pairs. */
int fd_flatten_renders_spans(FigdrawFlattenCtx *ctx, FdRenders *renders,
                             int32_t *spans, int spans_cap, int reserve);

/* Re-walk ONE root (layer `zlevel`, position `root_pos` in its root order)
 * appending its quads to ctx — the scratch patch walk. Returns the quad
 * count emitted, or -1 on a bad layer/root. */
int fd_flatten_renders_root(FigdrawFlattenCtx *ctx, FdRenders *renders,
                            int zlevel, int root_pos);

/* Demo-scene animator: writes the 300-box benchmark scene's frame-dependent
 * columns (box positions/sizes, corner radii, shadow blur/spread/offsets,
 * moving panel) straight into the FIG_DTYPE node array — bit-identical to
 * the numpy animator (figdraw_tpu/scenes.py). nodes points at the layer's
 * node rows; the phase tables are the Python-side caches, (9, copies) and
 * (7, copies) row-major f64. Returns 0, or -1 when count is too small for
 * the scene shape (1 + 3*copies + 3 rows). */
int fd_scene_animate(void *nodes, int32_t count, double w, double h,
                     double clamp_x, double clamp_y,
                     int32_t frame, int32_t copies, const double *base_xs,
                     const double *base_ys, const double *sin_of_sp,
                     const double *cos_of_sp, const double *sin_of_cp,
                     const double *cos_of_cp, const double *sin_t,
                     const double *cos_t);

/* Packed-fill helpers (filltypes.nim fill()/linear()). fill points at the
 * 16-byte PackedFill field inside a Fig row. axis: 0 X, 1 Y, 2 diagonal
 * TL-BR, 3 diagonal BL-TR. Colors are RGBA8. */
void fd_fill_solid(void *fill, uint8_t r, uint8_t g, uint8_t b, uint8_t a);
void fd_fill_linear2(void *fill, int axis, const uint8_t start[4],
                     const uint8_t stop[4]);
void fd_fill_linear3(void *fill, int axis, const uint8_t start[4],
                     const uint8_t mid[4], const uint8_t stop[4],
                     uint8_t mid_pos);

#ifdef __cplusplus
}
#endif

#endif /* FIGDRAW_FLATTEN_H */
