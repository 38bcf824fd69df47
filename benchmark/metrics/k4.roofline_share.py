"""K4's share of its roofline on the mesh: its least possible time over its
measured device time in the traced window, both in card-seconds.

A rotation moves every rank's shard one hop, rank r's card writing it into
rank r + 1's card over the link between them; K4 (`csrc/ring.cu`,
`ring_copy_kernel`) reads each word once and writes it once across the
link. The words a rotation sends, summed over the ranks, are the program's
`ring.words` counts (`parallel/ring.py`, where the rotation is issued). Each
card sends its own shard at once, so the least card-seconds of the window
are the words' bytes over one link direction's peak, summed over the
cards: sum(ring.words) * 4 B / LINK_BYTES_PER_S. The measured card-seconds
are the kernel's device time summed over the cards.

LINK_BYTES_PER_S is NVLink 4's published bandwidth a direction between two
H100 SXM5 cards, 18 links x 25 GB/s (NVIDIA H100 Tensor Core GPU data
sheet: 900 GB/s bidirectional). `nvidia-smi nvlink -s` on the cell's four
NVIDIA H100 80GB HBM3 cards lists 18 links a card at 26.562 GB/s each, the
links' signalling rate (478 GB/s). A checkout without the counts reads
None.
"""

from benchmark.harness import recorder

LINK_BYTES_PER_S = 450e9
WORD_BYTES = 4
KERNEL = "ring_copy_kernel"


def read(rec):
    words = recorder.total(rec, "ring.words")
    measured = rec["trace"].device_seconds(KERNEL)
    if not words or measured <= 0:
        return None
    return 100.0 * words * WORD_BYTES / LINK_BYTES_PER_S / measured
