"""AdamW's share of its roofline in the traced steps: the least time of
one update (each trainable element's fp32 parameter, gradient and two
moments read once, the parameter and moments written once: 28 bytes)
over the device time of the kernels whose names match ``PATTERNS``:
PyTorch's ``_foreach`` kernels (``multi_tensor_apply``) and the port's
hand-written update (csrc/adamw.cu), so that the work read is the same
whatever computes it. The elements are those of the run's reference
model, built on the meta device."""

from bench_port.peaks import peaks

PATTERNS = ("multi_tensor_apply", "tf_adamw")
BYTES_PER_ELEMENT = 28


def trainable_elements(ref, cfg) -> int:
    model = ref.build(cfg, "meta")
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def read(run):
    t = run.traced
    if t is None or not t.units:
        return None
    device_s = t.device_s_matching(PATTERNS)
    if device_s <= 0:
        return None
    _, bw = peaks(run.card)
    bound = BYTES_PER_ELEMENT * trainable_elements(run.ref, run.cfg) / bw
    return 100.0 * bound * t.units / device_s
