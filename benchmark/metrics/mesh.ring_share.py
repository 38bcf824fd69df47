"""The share of the cards' busy time that the ring's rotation takes: K4's
device time (`ring_copy_kernel`), summed over the cards, over the cards'
busy time summed over them (`busy_s` times the cards, each card's busy time
the union of its device intervals in the window)."""

KERNEL = "ring_copy_kernel"


def read(rec):
    tr = rec["trace"]
    busy = sum(tr.card_busy_s.values())
    k4 = tr.device_seconds(KERNEL)
    if busy <= 0 or k4 <= 0:
        return None
    return 100.0 * k4 / busy
