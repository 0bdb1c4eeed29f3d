"""The card's published peaks and the kernels' least times (the yardstick
of the roofline and ``mfu`` readers).

Peaks are NVIDIA's H100 data sheet, dense (no sparsity), keyed by the
name ``torch.cuda.get_device_name()`` gives: bf16 tensor-core FLOP/s and
HBM bytes/s. The bounds copy ``chip_smoke.py``'s formulas.
"""

from __future__ import annotations

PEAKS = (
    # name fragment, dense bf16 FLOP/s, HBM bytes/s
    ("H100 80GB HBM3", 989.4e12, 3.35e12),
    ("H100 PCIe", 756.5e12, 2.0e12),
    ("H100 NVL", 835.5e12, 3.9e12),
)


def peaks(card: str):
    """(bf16 FLOP/s, bytes/s) of the card; a card not in the table
    raises: there is no guessed default."""
    for key, flops, bw in PEAKS:
        if key in card:
            return flops, bw
    raise ValueError(f"no published peak for {card!r}; add it to PEAKS")


def attention_bound_s(b, t, h, d, elem_bytes, card) -> float:
    """softmax(q k^T / sqrt(D)) v over (B, T, H, D): the larger of q, k, v
    read and the output written once, and 4 B H T^2 D operations."""
    flops, bw = peaks(card)
    return max(4 * b * t * h * d * elem_bytes / bw,
               4 * b * h * t * t * d / flops)


def scatter_max_bound_s(b, n, c, segments, card) -> float:
    """B x N points of C fp32 features and an int32 id read once, the
    B x segments x C canvas written once."""
    _, bw = peaks(card)
    return (b * n * (c + 1) * 4 + b * segments * c * 4) / bw
