"""Device time a read streamed: the union of the device's busy intervals
in the traced window over the reads the window streamed through the align
and bin step (`_align_bin_batch` -> `align_batch`, seeding, K1, K2 + K3,
binning, the pileup and read-count accumulators)."""


def read(rec):
    if rec["work"] <= 0 or rec["busy_s"] <= 0:
        return None
    return rec["busy_s"] * 1e9 / rec["work"]
