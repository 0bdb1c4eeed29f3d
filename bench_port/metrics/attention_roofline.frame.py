"""Attention's share of its roofline in the traced compute frames: the
least time of every attention call of the members' forwards (the GPT
shapes of the configuration; bf16, the agent's compute dtype) over the
device time of the kernels whose names match ``PATTERNS``: the port's
hand-written kernels (csrc/attention.cu) and PyTorch's SDPA kernels, so
that the work read is the same whatever computes it."""

from bench_port.peaks import attention_bound_s

PATTERNS = ("attention_tc_bf16", "attention_tc_f32", "attention_kt",
            "flash_fwd", "fmha", "efficient_attention", "attention_kernel")
BF16_BYTES = 2


def bound_per_forward(ref, cfg, card):
    """One forward's attention calls at their least time; the GPTs'
    widths are those of the image trunk that ``ref`` builds on the meta
    device (every trunk has ``widths``)."""
    g = cfg.model.gpt
    t = (g.img_vert_anchors * g.img_horz_anchors
         + g.lidar_vert_anchors * g.lidar_horz_anchors)
    widths = ref.build(cfg, "meta")._model.image_encoder.features.widths
    return sum(g.n_layer * attention_bound_s(1, t, g.n_head, w // g.n_head,
                                             BF16_BYTES, card)
               for w in widths)


def read(run):
    t = run.traced
    if t is None or not t.units:
        return None
    device_s = t.device_s_matching(PATTERNS)
    if device_s <= 0:
        return None
    forwards = t.units * int(run.mix["members"])
    return (100.0 * bound_per_forward(run.ref, run.cfg, run.card) * forwards
            / device_s)
