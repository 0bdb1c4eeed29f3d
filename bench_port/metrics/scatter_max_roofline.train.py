"""The pillar scatter-max's share of its roofline in the traced steps:
the least time of one call at the configuration's shapes (batch x
max_lidar_points points of the PointNet's last width, the canvas's cells
and the sentinel) over the device time of the kernels whose names match
``PATTERNS`` (csrc/scatter_max.cu's two kernels)."""

from bench_port.peaks import scatter_max_bound_s

PATTERNS = ("scatter_keys", "decode_touched")
PIXELS_PER_METER = 8


def read(run):
    t = run.traced
    pp = run.cfg.model.point_pillars
    if t is None or not t.units or not pp.use_point_pillars:
        return None
    device_s = t.device_s_matching(PATTERNS)
    if device_s <= 0:
        return None
    cells = int((pp.max_x - pp.min_x) * PIXELS_PER_METER) * \
        int((pp.max_y - pp.min_y) * PIXELS_PER_METER) + 1
    bound = scatter_max_bound_s(int(run.mix["batch"]), pp.max_lidar_points,
                                pp.num_features[-1], cells, run.card)
    return 100.0 * bound * t.units / device_s
