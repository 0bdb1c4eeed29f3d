"""Pixel-exact numpy versions of the OpenCV rasterisers the hermetic camera
uses (``sim/sensors.py``): convex hull, convex polygon fill and open thick
polylines, all 8-connected without anti-aliasing. The nearest resize is
``data/decoders.resize_nearest``.

They follow OpenCV's integer rules step for step, so the masks equal
``cv2.convexHull`` / ``cv2.fillConvexPoly`` / ``cv2.polylines`` pixel for
pixel (tests/test_torch_raster.py holds them to OpenCV):

  * lines are clipped to the image first (``clipLine``, double-precision
    intersections truncated to integers) and then walked by Bresenham from
    the left end (``LineIterator``), or, for polygons given in 16-bit
    fixed point, by the fixed-point walker ``Line2``;
  * a convex fill draws its outline and then scans rows between two edges
    whose x advances by a rounded fixed-point step (``FillConvexPoly``);
  * a thick segment is clipped to the image grown by its thickness, then
    drawn as a fixed-point quad plus filled midpoint circles at its joints
    (``ThickLine``, ``Circle``);
  * the hull is Sklansky's scan over points sorted by (x, y), with
    OpenCV's output order (``convexHull``, clockwise=False).

Every primitive paints one colour, so its pixels are a union that does
not depend on the drawing order: many lines, polygons or circles are
drawn at once with array operations. The only Python loop of a fill runs
over the rows where some polygon changes edges.
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1


def _cdiv(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """C integer division: the quotient truncated toward zero."""
    q = np.abs(a) // np.abs(b)
    return np.where((a < 0) == (b < 0), q, -q)


def _i64(*xs):
    return [np.asarray(x, np.int64).reshape(-1) for x in xs]


def _clip_lines(w: int, h: int, x1, y1, x2, y2):
    """OpenCV's ``clipLine`` to [0, w-1] x [0, h-1] for arrays of
    segments (intersections in double precision, truncated).
    -> (x1, y1, x2, y2, inside)."""
    x1, y1, x2, y2 = _i64(x1, y1, x2, y2)
    right, bottom = w - 1, h - 1

    def code(x, y, with_y=True):
        c = (x < 0) * 1 + (x > right) * 2
        return c + (y < 0) * 4 + (y > bottom) * 8 if with_y else c

    def cross(a, p, dp, dq):
        """trunc(double(a - p) * dq / dp), safe where dp == 0."""
        with np.errstate(divide="ignore", invalid="ignore"):
            f = (a - p).astype(np.float64) * dq.astype(np.float64) \
                / dp.astype(np.float64)
        return np.trunc(np.where(dp != 0, f, 0.0)).astype(np.int64)

    c1, c2 = code(x1, y1), code(x2, y2)
    todo = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = todo & ((c1 & 12) != 0)
    a = np.where(c1 < 8, 0, bottom)
    x1 = np.where(m, x1 + cross(a, y1, y2 - y1, x2 - x1), x1)
    y1 = np.where(m, a, y1)
    c1 = np.where(m, code(x1, y1, False), c1)
    m = todo & ((c2 & 12) != 0)
    a = np.where(c2 < 8, 0, bottom)
    x2 = np.where(m, x2 + cross(a, y2, y2 - y1, x2 - x1), x2)
    y2 = np.where(m, a, y2)
    c2 = np.where(m, code(x2, y2, False), c2)
    todo &= ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = todo & (c1 != 0)
    a = np.where(c1 == 1, 0, right)
    y1 = np.where(m, y1 + cross(a, x1, x2 - x1, y2 - y1), y1)
    x1 = np.where(m, a, x1)
    c1 = np.where(m, 0, c1)
    m = todo & (c2 != 0)
    a = np.where(c2 == 1, 0, right)
    y2 = np.where(m, y2 + cross(a, x2, x2 - x1, y2 - y1), y2)
    x2 = np.where(m, a, x2)
    c2 = np.where(m, 0, c2)
    return x1, y1, x2, y2, (c1 | c2) == 0


def _expand(counts: np.ndarray):
    """-> (segment index, position within the segment) of every element of
    segments with the given lengths."""
    counts = np.maximum(counts, 0)
    seg = np.repeat(np.arange(counts.size), counts)
    start = np.cumsum(counts) - counts
    return seg, np.arange(seg.size, dtype=np.int64) - start[seg]


def _put(img: np.ndarray, xs: np.ndarray, ys: np.ndarray, color) -> None:
    h, w = img.shape[:2]
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def _lines(img: np.ndarray, x1, y1, x2, y2, color) -> None:
    """``Line`` (integer end points, 8-connected) for arrays of segments:
    clip, then Bresenham from the left end."""
    h, w = img.shape[:2]
    x1, y1, x2, y2, ok = _clip_lines(w, h, x1, y1, x2, y2)
    x1, y1, x2, y2 = x1[ok], y1[ok], x2[ok], y2[ok]
    flip = x2 < x1
    x1, x2 = np.where(flip, x2, x1), np.where(flip, x1, x2)
    y1, y2 = np.where(flip, y2, y1), np.where(flip, y1, y2)
    dx, dy = x2 - x1, y2 - y1
    sy = np.where(dy < 0, -1, 1)
    dy = np.abs(dy)
    vert = dy > dx
    major, minor = np.where(vert, dy, dx), np.where(vert, dx, dy)
    seg, k = _expand(major + 1)
    M, N = major[seg], minor[seg]
    # minor-axis steps taken before pixel k: ceil((2 N k - M) / (2 M)),
    # the closed form of LineIterator's error-term walk
    mk = np.where(M > 0, -((M - 2 * N * k) // np.maximum(2 * M, 1)), 0)
    v = vert[seg]
    xs = x1[seg] + np.where(v, mk, k)
    ys = y1[seg] + sy[seg] * np.where(v, k, mk)
    _put(img, xs, ys, color)


def _lines2(img: np.ndarray, x1, y1, x2, y2, color) -> None:
    """``Line2`` (end points in 16-bit fixed point) for arrays of
    segments."""
    h, w = img.shape[:2]
    x1, y1, x2, y2, ok = _clip_lines(w << XY_SHIFT, h << XY_SHIFT,
                                     x1, y1, x2, y2)
    x1, y1, x2, y2 = x1[ok], y1[ok], x2[ok], y2[ok]
    dx, dy = x2 - x1, y2 - y1
    horiz = np.abs(dx) > np.abs(dy)
    # walk from the end with the smaller major coordinate
    flip = np.where(horiz, dx < 0, dy < 0)
    x1, x2 = np.where(flip, x2, x1), np.where(flip, x1, x2)
    y1, y2 = np.where(flip, y2, y1), np.where(flip, y1, y2)
    minor = np.where(horiz, np.where(flip, -dy, dy), np.where(flip, -dx, dx))
    step = _cdiv(minor << XY_SHIFT,
                 np.where(horiz, np.abs(dx), np.abs(dy)) | 1)
    ecount = np.where(horiz, x2 - x1, y2 - y1) >> XY_SHIFT
    x1 = x1 + _HALF
    y1 = y1 + _HALF
    seg, k = _expand(ecount + 1)
    hz = horiz[seg]
    xs = np.where(hz, (x1[seg] >> XY_SHIFT) + k,
                  (x1[seg] + k * step[seg]) >> XY_SHIFT)
    ys = np.where(hz, (y1[seg] + k * step[seg]) >> XY_SHIFT,
                  (y1[seg] >> XY_SHIFT) + k)
    _put(img, np.concatenate([xs, (x2 + _HALF) >> XY_SHIFT]),
         np.concatenate([ys, (y2 + _HALF) >> XY_SHIFT]), color)


def _spans(img: np.ndarray, rows, x0, x1, color) -> None:
    """Set img[row, x0..x1] (inclusive, clipped) for arrays of spans."""
    h, w = img.shape[:2]
    rows, x0, x1 = _i64(rows, x0, x1)
    x0, x1 = np.maximum(x0, 0), np.minimum(x1, w - 1)
    keep = (rows >= 0) & (rows < h) & (x0 <= x1)
    rows, x0, x1 = rows[keep], x0[keep], x1[keep]
    seg, k = _expand(x1 - x0 + 1)
    img[rows[seg], x0[seg] + k] = color


def fill_convex_polys(img: np.ndarray, polys, color, shift: int = 0
                      ) -> None:
    """``cv2.fillConvexPoly(img, poly, color, LINE_8, shift)`` in place for
    each of the (Q, n, 2) polygons, all at once."""
    v = np.asarray(polys, np.int64)
    q_count, n = v.shape[:2]
    if q_count == 0 or n == 0:
        return
    h, w = img.shape[:2]
    delta = (1 << shift) >> 1
    up = XY_SHIFT - shift

    # the outline, each edge from the previous vertex
    prev = np.roll(v, 1, axis=1).reshape(-1, 2)
    cur = v.reshape(-1, 2)
    if shift == 0:
        _lines(img, prev[:, 0], prev[:, 1], cur[:, 0], cur[:, 1], color)
    else:
        _lines2(img, prev[:, 0] << up, prev[:, 1] << up,
                cur[:, 0] << up, cur[:, 1] << up, color)
    if n < 3:
        return

    # the scan: per polygon two edges walk down from the first topmost
    # vertex; each pass of this loop is one change of edges (the rows up
    # to the next change advance linearly and are painted together)
    vx, vy = v[..., 0] << up, v[..., 1]
    ty_all = (vy + delta) >> shift
    imin = np.argmin(vy, axis=1)
    ymin = (vy.min(1) + delta) >> shift
    ymax = (vy.max(1) + delta) >> shift
    xmin = (v[..., 0].min(1) + delta) >> shift
    xmax = (v[..., 0].max(1) + delta) >> shift
    active = (xmax >= 0) & (ymax >= 0) & (xmin < w) & (ymin < h)
    ymax = np.minimum(ymax, h - 1)
    q = np.arange(q_count)
    di = np.array([1, n - 1])
    idx = np.stack([imin, imin], 1)
    ex = np.full((q_count, 2), -XY_ONE, np.int64)
    edx = np.zeros((q_count, 2), np.int64)
    ye = np.stack([ymin, ymin], 1)
    edges = np.full(q_count, n, np.int64)
    y = ymin.copy()
    runs = []
    while active.any():
        for i in range(2):
            search = active & (y >= ye[:, i])
            idx0 = idx[:, i].copy()
            nxt = (idx0 + di[i]) % n
            while search.any():
                edges[search] -= 1
                search &= edges >= 0
                ty = ty_all[q, nxt]
                found = search & (ty > y)
                if found.any():
                    xs = vx[q[found], idx0[found]]
                    xe = vx[q[found], nxt[found]]
                    dyr = ty[found] - y[found]
                    ye[found, i] = ty[found]
                    edx[found, i] = _cdiv((xe - xs) * 2 + dyr, 2 * dyr)
                    ex[found, i] = xs
                    idx[found, i] = nxt[found]
                search &= ~found
                idx0 = np.where(search, nxt, idx0)
                nxt = np.where(search, (nxt + di[i]) % n, nxt)
        active &= edges >= 0
        stop = np.minimum(np.minimum(ye[:, 0], ye[:, 1]), ymax + 1)
        nrun = np.maximum(stop - y, 1)
        a = np.nonzero(active)[0]
        # only rows inside the image are expanded
        k0 = np.clip(-y[a], 0, nrun[a])
        k1 = np.clip(h - y[a], k0, nrun[a])
        runs.append((y[a] + k0, k1 - k0, ex[a] + k0[:, None] * edx[a],
                     edx[a]))
        ex += np.where(active, nrun, 0)[:, None] * edx
        y = np.where(active, y + nrun, y)
        active &= y <= ymax
    if not runs:
        return
    y0, cnt, x0, dx = (np.concatenate(r) for r in zip(*runs))
    seg, k = _expand(cnt)
    xa = x0[seg] + k[:, None] * dx[seg]
    lo = (xa.min(1) + _HALF) >> XY_SHIFT
    hi = (xa.max(1) + _HALF) >> XY_SHIFT
    _spans(img, y0[seg] + k, lo, hi, color)


def _circle_spans(radius: int) -> np.ndarray:
    """(row offset, x0 offset, x1 offset) of ``Circle(..., fill=1)``'s
    midpoint walk."""
    spans = []
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        spans += [(-dy, -dx, dx), (dy, -dx, dx), (-dx, -dy, dy),
                  (dx, -dy, dy)]
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    return np.asarray(spans, np.int64)


def polylines(img: np.ndarray, lines, color, thickness: int) -> None:
    """``cv2.polylines(img, lines, False, color, thickness)`` (LINE_8,
    shift 0) in place for a list of open polylines. A thick segment is
    clipped to the image grown by the thickness, then drawn as a
    fixed-point quad, with round joints at the start of each polyline's
    first segment and at the end of every segment; thickness 1 draws
    Bresenham lines."""
    lines = [np.asarray(p, np.int64).reshape(-1, 2) for p in lines]
    lines = [p for p in lines if len(p) > 1]
    if not lines:
        return
    a = np.concatenate([p[:-1] for p in lines])
    b = np.concatenate([p[1:] for p in lines])
    first = np.zeros(len(a), bool)
    first[np.cumsum([0] + [len(p) - 1 for p in lines[:-1]])] = True
    h, w = img.shape[:2]
    if thickness <= 1:
        _lines(img, a[:, 0], a[:, 1], b[:, 0], b[:, 1], color)
        return
    m = thickness
    x0, y0, x1, y1, ok = _clip_lines(w + 2 * m, h + 2 * m,
                                     a[:, 0] + m, a[:, 1] + m,
                                     b[:, 0] + m, b[:, 1] + m)
    first, x0, y0, x1, y1 = first[ok], x0[ok], y0[ok], x1[ok], y1[ok]
    x0, y0, x1, y1 = (((c - m) << XY_SHIFT) for c in (x0, y0, x1, y1))
    half = thickness << (XY_SHIFT - 1)
    dx = (x0 - x1) / XY_ONE
    dy = (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    quad = np.abs(r) > np.finfo(np.float64).eps
    r = (half + (thickness & 1) * XY_ONE * 0.5) / np.sqrt(r[quad])
    px = np.rint(dy[quad] * r).astype(np.int64)  # cvRound: half to even
    py = np.rint(dx[quad] * r).astype(np.int64)
    a0, b0, a1, b1 = x0[quad], y0[quad], x1[quad], y1[quad]
    fill_convex_polys(img, np.stack([
        np.stack([a0 + px, b0 + py], 1), np.stack([a0 - px, b0 - py], 1),
        np.stack([a1 - px, b1 - py], 1), np.stack([a1 + px, b1 + py], 1)],
        1), color, shift=XY_SHIFT)
    cx = np.concatenate([x0[first], x1])
    cy = np.concatenate([y0[first], y1])
    cx, cy = (cx + _HALF) >> XY_SHIFT, (cy + _HALF) >> XY_SHIFT
    spans = _circle_spans((half + _HALF) >> XY_SHIFT)
    _spans(img, (cy[:, None] + spans[None, :, 0]).ravel(),
           (cx[:, None] + spans[None, :, 1]).ravel(),
           (cx[:, None] + spans[None, :, 2]).ravel(), color)


def _sklansky(pts, start: int, end: int, stack: list, nsign: int,
              sign2: int) -> int:
    """One quarter of OpenCV's hull scan over the sorted points; fills
    ``stack`` from its start and returns its size."""
    incr = 1 if end > start else -1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    if start == end or pts[start] == pts[end]:
        stack[0] = start
        return 1
    stack[0:3] = [pprev, pcur, pnext]
    size = 3
    end += incr
    while pnext != end:
        cury, nexty = pts[pcur][1], pts[pnext][1]
        by = nexty - cury
        if (by > 0) - (by < 0) != nsign:
            ax = pts[pcur][0] - pts[pprev][0]
            bx = pts[pnext][0] - pts[pcur][0]
            ay = cury - pts[pprev][1]
            convexity = ay * bx - ax * by
            if (convexity > 0) - (convexity < 0) == sign2 and \
                    (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack[size] = pnext
                size += 1
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[size - 2] = pnext
                pcur = pprev
                pprev = stack[size - 4]
                size -= 1
        else:
            pnext += incr
            stack[size - 1] = pnext
    return size - 1


def convex_hull(points) -> np.ndarray:
    """``cv2.convexHull(points)[:, 0]`` for integer points (clockwise=False,
    the same vertices in the same order). Ties in the (x, y) sort keep
    the input order, as OpenCV's insertion sort does for up to 16
    points."""
    data = [(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)]
    total = len(data)
    if total == 0:
        return np.zeros((0, 2), np.int32)
    order = sorted(range(total), key=lambda i: data[i])
    pts = [data[i] for i in order]
    miny = maxy = 0
    for i in range(1, total):
        if pts[miny][1] > pts[i][1]:
            miny = i
        if pts[maxy][1] < pts[i][1]:
            maxy = i
    hull = []
    stack = [0] * (total + 3)
    if pts[0] == pts[-1]:
        hull.append(order[0])
    else:
        # upper half (counter-clockwise output: right part first)
        tl = _sklansky(pts, 0, maxy, stack, -1, 1)
        tl_stack = stack[:tl]
        tr = _sklansky(pts, total - 1, maxy, stack, -1, -1)
        tr_stack = stack[:tr]
        tl_stack, tr_stack, tl, tr = tr_stack, tl_stack, tr, tl
        hull += [order[tl_stack[i]] for i in range(tl - 1)]
        hull += [order[tr_stack[i]] for i in range(tr - 1, 0, -1)]
        stop = tr_stack[1] if tr > 2 else (tl_stack[tl - 2] if tl > 2
                                           else -1)
        # lower half
        bl = _sklansky(pts, 0, miny, stack, 1, -1)
        bl_stack = stack[:bl]
        br = _sklansky(pts, total - 1, miny, stack, 1, 1)
        br_stack = stack[:br]
        if stop >= 0:
            check = bl_stack[1] if bl > 2 else (
                br_stack[2 - bl] if bl + br > 2 else -1)
            if check == stop or (check >= 0 and pts[check] == pts[stop]):
                # all points on one line: the lower part mirrors the upper
                bl, br = min(bl, 2), min(br, 2)
        hull += [order[bl_stack[i]] for i in range(bl - 1)]
        hull += [order[br_stack[i]] for i in range(br - 1, 0, -1)]
        hull = _cyclic_shift(hull)
    return np.asarray([data[i] for i in hull], np.int32).reshape(-1, 2)


def _cyclic_shift(hull: list) -> list:
    """OpenCV's final rotation that makes the hull's input indices an
    ascending or descending run where a cyclic shift can."""
    nout = len(hull)
    if nout < 3:
        return hull
    min_idx = max_idx = lt = 0
    for i in range(1, nout):
        idx = hull[i]
        lt += hull[i - 1] < idx
        if 1 < lt <= i - 2:
            break
        if idx < hull[min_idx]:
            min_idx = i
        if idx > hull[max_idx]:
            max_idx = i
    mmdist = abs(max_idx - min_idx)
    if (mmdist == 1 or mmdist == nout - 1) and (lt <= 1 or lt >= nout - 2):
        ascending = (max_idx + 1) % nout == min_idx
        i0 = min_idx if ascending else max_idx
        if i0 > 0:
            out, j = [], i0
            for i in range(nout):
                cur = hull[j]
                out.append(cur)
                nj = j + 1 if j + 1 < nout else 0
                if i < nout - 1 and ascending != (cur < hull[nj]):
                    break
                j = nj
            if len(out) == nout:
                return out
    return hull
