"""Connected-component labeling.

The AprilTag C library segments the thresholded image with union-find
(N1, SURVEY.md §2.1); union-find is irregular and hostile to XLA, so this
uses the data-parallel alternative: rounds of min-label propagation, each
a forward+backward segmented min-scan along rows, the same along columns,
and a 3x3 neighbour-min stencil. Scans carry a label across a whole
straight run in one pass, so a quad ring converges in ~4 rounds.

Labels are linear pixel indices; background pixels get label = H*W
(sentinel). Same-class 8-neighbors merge.

Two implementations of the segmented scan, bit-identical (labels are
integers and the minimum is exact):
  * `_connected_components_xla` — `lax.associative_scan`, the reference
    and the path on every platform but CUDA;
  * `_connected_components_triton` — a Pallas kernel through Triton: one
    program per block of columns walks the rows with the running minimum
    in registers, so each pass reads and writes every pixel once instead
    of the ~2*log2(n) passes of the associative scan's slice tree. Row
    scans run the same kernel on the transposed labels.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def connected_components(mask: jnp.ndarray, iters: int = 5,
                         connectivity: int = 8) -> jnp.ndarray:
    """Label connected True-regions of `mask` (H,W bool).

    Returns (H,W) int32 labels: the minimum linear pixel index of the
    component; H*W for background. The Triton scan kernel serves CUDA
    devices, the XLA scan formulation every other platform."""
    return jax.lax.platform_dependent(
        mask,
        cuda=functools.partial(_connected_components_triton, iters=iters,
                               connectivity=connectivity),
        default=functools.partial(_connected_components_xla, iters=iters,
                                  connectivity=connectivity))


def _label_rounds(mask, iters, connectivity, seg_scan):
    """`iters` propagation rounds; `seg_scan(lab, axis)` is the forward-
    then-backward segmented min-scan along `axis` (run-reset at
    background pixels, output sentinel there)."""
    h, w = mask.shape
    idx = (jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) * w
           + jax.lax.broadcasted_iota(jnp.int32, (h, w), 1))
    sentinel = jnp.int32(h * w)
    labels = jnp.where(mask, idx, sentinel)

    def neighbor_min(lab):
        """Min label over same-class neighbors (mask-True pixels only)."""
        p = jnp.pad(lab, 1, constant_values=sentinel)
        m = lab
        shifts = [(-1, 0), (1, 0), (0, -1), (0, 1)]
        if connectivity == 8:
            shifts += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
        for dy, dx in shifts:
            m = jnp.minimum(m, p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w])
        return jnp.where(mask, m, sentinel)

    def body(_, lab):
        lab = seg_scan(lab, 1)
        lab = seg_scan(lab, 0)
        return neighbor_min(lab)

    return jax.lax.fori_loop(0, iters, body, labels)


@functools.partial(jax.jit, static_argnames=("iters", "connectivity"))
def _connected_components_xla(mask: jnp.ndarray, iters: int = 5,
                              connectivity: int = 8) -> jnp.ndarray:
    """`connected_components` with `lax.associative_scan` segmented scans
    (the plain reference for the Triton kernel)."""
    sentinel = jnp.int32(mask.shape[0] * mask.shape[1])
    brk = ~mask

    def combine(a, b):
        av, ab_ = a
        bv, bb = b
        return (jnp.where(bb, bv, jnp.minimum(av, bv)), ab_ | bb)

    def one_way(lab, axis, reverse):
        v, _ = jax.lax.associative_scan(combine, (lab, brk), axis=axis,
                                        reverse=reverse)
        return jnp.where(mask, v, sentinel)

    def seg_scan(lab, axis):
        return one_way(one_way(lab, axis, False), axis, True)

    return _label_rounds(mask, iters, connectivity, seg_scan)


# columns per kernel program (lanes), rows loaded per loop step, warps per
# program: the fastest of a sweep on the H100 (PERF.md, PR 1)
_BLOCK_COLS = 32
_ROWS_PER_STEP = 16
_NUM_WARPS = 1


def _seg_min_scan_kernel(mask_ref, lab_ref, out_ref, *, sentinel: int,
                         reverse: bool):
    """One program = one block of columns; walks the rows in order
    (`reverse`: bottom-up) carrying the running segmented minimum. Each
    loop step loads _ROWS_PER_STEP rows at once, so their loads are in
    flight together before the sequential min chain consumes them."""
    h, w = lab_ref.shape
    c0 = pl.program_id(0) * _BLOCK_COLS
    cols = pl.ds(c0, _BLOCK_COLS)
    in_w = c0 + jnp.arange(_BLOCK_COLS) < w

    def step(g, run):
        loaded = []
        for k in range(_ROWS_PER_STEP):
            i = g * _ROWS_PER_STEP + k
            r = h - 1 - i if reverse else i
            ok = in_w & (i < h)
            loaded.append((
                r, ok,
                plgpu.load(mask_ref.at[r, cols], mask=ok, other=0) != 0,
                plgpu.load(lab_ref.at[r, cols], mask=ok, other=sentinel)))
        for r, ok, m, lab in loaded:
            run = jnp.where(m, jnp.minimum(run, lab), lab)
            plgpu.store(out_ref.at[r, cols], jnp.where(m, run, sentinel),
                        mask=ok)
        return run

    jax.lax.fori_loop(0, pl.cdiv(h, _ROWS_PER_STEP), step,
                      jnp.full((_BLOCK_COLS,), sentinel, jnp.int32))


def _column_scan(mask_i8, lab, sentinel, interpret):
    """Forward then backward segmented min-scan down the columns."""
    h, w = lab.shape
    for reverse in (False, True):
        lab = pl.pallas_call(
            functools.partial(_seg_min_scan_kernel, sentinel=sentinel,
                              reverse=reverse),
            out_shape=jax.ShapeDtypeStruct((h, w), jnp.int32),
            grid=(pl.cdiv(w, _BLOCK_COLS),),
            compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
            interpret=interpret,
            name="ccl_seg_min_scan",
        )(mask_i8, lab)
    return lab


@functools.partial(jax.jit, static_argnames=("iters", "connectivity",
                                             "interpret"))
def _connected_components_triton(mask: jnp.ndarray, iters: int = 5,
                                 connectivity: int = 8,
                                 interpret: bool = False) -> jnp.ndarray:
    """`connected_components` with the Triton segmented-scan kernel."""
    sentinel = mask.shape[0] * mask.shape[1]
    mask_i8 = mask.astype(jnp.int8)
    mask_t = mask_i8.T
    scan = functools.partial(_column_scan, sentinel=sentinel,
                             interpret=interpret)

    def seg_scan(lab, axis):
        if axis == 0:
            return scan(mask_i8, lab)
        return scan(mask_t, lab.T).T

    return _label_rounds(mask, iters, connectivity, seg_scan)


def _component_runs(flat: jnp.ndarray, sentinel: int):
    """Exact per-component areas WITHOUT a scatter: sort the flat label
    array, count run lengths via a reverse min-scan over run-start
    positions.

    `sentinel` is the background label value (>= any real label).
    Returns (run_label (N,), run_area (N,) f32) — nonzero area only at
    run-start positions; background (sentinel) runs get area 0. Ties in
    a top_k over run_area break toward smaller labels, matching the
    dense-histogram formulation (positions are sorted by label)."""
    n = flat.shape[0]
    s = jnp.sort(flat)
    pos = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    is_start = jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]])
    sp = jnp.where(is_start, pos, n)
    # lax.cummin, NOT lax.associative_scan(jnp.minimum): identical inclusive
    # reverse min-scan as one primitive, where associative_scan's generic
    # lowering builds a deep tree of slices that is slow to compile once
    # batched
    nxt_incl = jax.lax.cummin(sp, axis=0, reverse=True)
    nxt = jnp.concatenate([nxt_incl[1:], jnp.full(1, n, jnp.int32)])
    area = jnp.where(is_start & (s < sentinel),
                     (nxt - pos).astype(jnp.float32), 0.0)
    return s, area


def top_k_components(labels: jnp.ndarray, k: int,
                     min_area: float = 1.0, max_area: float = jnp.inf,
                     ring_filter: bool = False, min_side: float = 8.0,
                     return_bbox: bool = False):
    """Select the k largest components (optionally ring-like ones only).

    With ring_filter, the 2k largest area-gated components are screened by
    quad-border plausibility — bbox fill ratio in [0.1, 0.95] (a tag's
    black border ring fills ~30-60% of its bbox; thin lines and solid
    blobs fall outside) and bbox aspect in [0.2, 5] — so background blobs
    don't crowd small tag rings out of the k slots. Bboxes come from
    masked reductions over the candidate set (one (2k,N) compare) instead
    of full-image scatters.

    Returns (root_labels (k,) int32, areas (k,) f32, valid (k,) bool);
    with return_bbox (ring path only), additionally a (k,4) f32
    [xmin, ymin, xmax, ymax] stride-2-estimated bbox per slot (each edge
    within ~2 px of true for solid borders; callers must pad).
    """
    h, w = labels.shape
    if not ring_filter:
        run_label, run_area = _component_runs(labels.reshape(-1),
                                              sentinel=h * w)
        ok = (run_area >= min_area) & (run_area <= max_area)
        scored = jnp.where(ok, run_area, 0.0)
        top_areas, top_pos = jax.lax.top_k(scored, k)
        return run_label[top_pos].astype(jnp.int32), top_areas, top_areas > 0

    # ring path (the detector): everything runs on a stride-2 subsample
    # of the label image, which quarters the sort and the (2k, N)
    # membership compare. Areas become (count on the stride-2 grid) * 4:
    # an unbiased estimate whose noise is far inside the min/max-area and
    # fill-ratio gate margins for any decodable component (>= 8 px
    # across). The <=1
    # px bbox-extent underestimate is folded into bw/bh (+2 instead of
    # +1), and ymin stays exact via the root fold (labels are min
    # row-major pixel indices, so the root's row IS the top row).
    lab2 = labels[::2, ::2]
    h2, w2 = lab2.shape
    run_label, run_area = _component_runs(lab2.reshape(-1), sentinel=h * w)
    run_area = run_area * 4.0
    ok = (run_area >= min_area) & (run_area <= max_area)
    scored = jnp.where(ok, run_area, 0.0)
    cand_areas, cand_pos = jax.lax.top_k(scored, 2 * k)
    cand_idx = run_label[cand_pos].astype(jnp.int32)
    m = lab2.reshape(-1)[None, :] == cand_idx[:, None]   # (2k, N/4)
    xs = 2.0 * jax.lax.broadcasted_iota(jnp.float32, (h2, w2), 1).reshape(-1)
    ys = 2.0 * jax.lax.broadcasted_iota(jnp.float32, (h2, w2), 0).reshape(-1)
    big = jnp.float32(1e9)
    # the root pixel (label = min row-major index) is always a member:
    # folding it in keeps the bbox non-empty even if a thin component
    # has no pixel on the stride-2 grid
    x_root = (cand_idx % w).astype(jnp.float32)
    y_root = (cand_idx // w).astype(jnp.float32)
    xmin = jnp.minimum(jnp.min(jnp.where(m, xs[None, :], big), axis=1),
                       x_root)
    xmax = jnp.maximum(jnp.max(jnp.where(m, xs[None, :], -big), axis=1),
                       x_root)
    ymin = jnp.minimum(jnp.min(jnp.where(m, ys[None, :], big), axis=1),
                       y_root)
    ymax = jnp.maximum(jnp.max(jnp.where(m, ys[None, :], -big), axis=1),
                       y_root)
    bw = xmax - xmin + 2.0
    bh = ymax - ymin + 2.0
    fill = cand_areas / jnp.maximum(bw * bh, 1.0)
    aspect = bw / jnp.maximum(bh, 1.0)
    ring_ok = (cand_areas > 0) & (fill > 0.10) & (fill < 0.95) & \
        (aspect > 0.2) & (aspect < 5.0) & \
        (bw >= min_side) & (bh >= min_side)
    final_scores, final_slots = jax.lax.top_k(
        jnp.where(ring_ok, cand_areas, 0.0), k)
    out = (cand_idx[final_slots].astype(jnp.int32), final_scores,
           final_scores > 0)
    if return_bbox:
        bbox = jnp.stack([xmin, ymin, xmax, ymax], axis=1)[final_slots]
        out = out + (bbox,)
    return out
