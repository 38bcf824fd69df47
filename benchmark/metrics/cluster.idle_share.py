"""The share of the traced window in which the device ran nothing while
the cluster stage (`cluster_stage` -> `cluster_round0_core`) ran:
1 - busy / window."""


def read(rec):
    if rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
