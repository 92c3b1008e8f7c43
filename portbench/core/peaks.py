"""Published peaks of the cards the benchmark runs on.

HBM bandwidth from NVIDIA's H100 data sheet: the SXM part (80 GB HBM3)
3.35 TB/s at its 700 W limit.  A roofline share is stated against it,
with the card's power limit (``nvidia-smi``) beside it in the run's log;
a card not listed reads no roofline.
"""

from __future__ import annotations

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_bytes_per_s(card: str) -> float | None:
    return HBM_BYTES_PER_S.get(card)
