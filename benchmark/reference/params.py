"""The pipeline's parameters as the reference reads them: the fields and
defaults of the repository's frozen `PipelineConfig`, with a deployment's
`settings` laid over them."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Params:
    read_len_max: int = 128
    window_margin: int = 16
    ref_len_max: int = 2048
    k: int = 15
    seed_stride: int = 8
    bucket_cap: int = 16
    diag_bin: int = 16
    max_candidates: int = 4
    match: int = 1
    mismatch: int = -4
    gap_open: int = 6
    gap_extend: int = 1
    min_score: int = 40
    bin_score_delta: int = 0
    bin_share_depth: int = 10
    dp_lambda_num: int = 3
    dp_lambda_den: int = 10
    dp_spawn_min_orphans: int = 3
    dp_spawn_scan: int = 8
    max_clusters_per_bin: int = 8
    max_poly_cols: int = 64
    poly_minor_frac_num: int = 3
    poly_minor_frac_den: int = 20
    poly_min_minor_count: int = 4
    dp_max_iters: int = 16
    min_cluster_reads: int = 3
    min_coverage: int = 2
    vote_min_frac_num: int = 1
    vote_min_frac_den: int = 4
    vote_min_abs: int = 6
    minorhap_min_cols: int = 2
    minorhap_min_abs: int = 4
    minorhap_max_num: int = 1
    minorhap_max_den: int = 3
    minorhap_frac_num: int = 3
    minorhap_frac_den: int = 20
    max_bin_reads: int = 4096

    @property
    def neg_inf(self) -> int:
        return -(1 << 20)

    @property
    def window_len(self) -> int:
        return self.read_len_max + 2 * self.window_margin

    @property
    def n_diag_bins(self) -> int:
        return (self.ref_len_max + self.read_len_max) // self.diag_bin + 2

    @staticmethod
    def of(settings: dict) -> "Params":
        """The defaults with the settings that the reference reads laid
        over them (settings that only steer the program are ignored)."""
        names = {f.name for f in dataclasses.fields(Params)}
        return Params(**{k: v for k, v in settings.items() if k in names})
