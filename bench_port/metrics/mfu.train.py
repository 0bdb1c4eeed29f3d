"""The whole training step's share of the card's dense bf16 peak: the
reference model's FLOPs of one step (``flops.train_step_flops``: forward
with the auxiliary maps, loss, backward; on the meta device) x the timed
steps, over the window's wall time and the peak."""

from bench_port.peaks import peaks


def read(run):
    if not run.units or not run.window_s > 0:
        return None
    peak, _ = peaks(run.card)
    return 100.0 * run.flops_per_unit * run.units / run.window_s / peak
