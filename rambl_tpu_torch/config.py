"""Frozen configuration of the pipeline: the port's copy of `rambl_tpu/config.py`.

Every knob that affects output bits lives in one frozen dataclass, so that the
NumPy oracle, the JAX package and this port consume identical parameters. The
fields, defaults and PRESETS are the reference's, unchanged
(`dataclasses.asdict` of every preset is held equal in
tests/test_torch_host_layers.py); some fields (`sw_impl`,
`mesh_data_axis`) only steer the JAX package and are kept so that a config
means the same thing in both packages. `ring_impl` steers both: the port's
`parallel.ring_dma.ring_rotate` takes it.

The five BASELINE configs (BASELINE.json:6-12) are exposed as named PRESETS.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class ScoringParams:
    """Affine-gap local-alignment scoring (BWA-MEM default parameterization).

    Gap of length g costs gap_open + g * gap_extend.
    """

    match: int = 1
    mismatch: int = -4
    gap_open: int = 6
    gap_extend: int = 1

    @property
    def neg_inf(self) -> int:
        # Safe "minus infinity" for int32 DP that cannot overflow when added to.
        return -(1 << 20)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # ---- read/reference geometry (static shapes; SURVEY.md section 7.4.2) ----
    read_len_max: int = 128          # reads padded to this length (sublane axis)
    window_margin: int = 16          # ref window = read_len_max + 2*margin
    ref_len_max: int = 2048          # max reference/consensus sequence length

    # ---- seeding ----
    k: int = 15                      # k-mer size (2k=30 bits, fits int32 keys)
    seed_stride: int = 8             # query k-mer sampling stride
    bucket_cap: int = 16             # max hits scanned per seed-table bucket
    diag_bin: int = 16               # diagonal quantization for candidate voting
    max_candidates: int = 4          # top-C candidate windows per read per strand

    # ---- alignment ----
    scoring: ScoringParams = dataclasses.field(default_factory=ScoringParams)
    sw_impl: str = "auto"            # "auto" | "pallas" | "scan": score-pass
                                     # kernel (auto = pallas on TPU backends)
    # Pallas score kernel computes only this many query rows (0 = all
    # read_len_max). EXACT whenever every read's length fits (pad rows can
    # never win the DP - ops/sw_pallas.py docstring proof); 100bp reads in
    # the default 128-pad layout waste 23% of the wavefront otherwise.
    # Must be a multiple of 8 and >= the longest real read; the stream
    # checks this against the actual read lengths.
    sw_rows: int = 0
    min_score: int = 40              # below this a read is unaligned (bin -1)
    max_gap_per_row: int = 8         # traceback: max consecutive ref-gap moves

    # ---- binning ----
    bin_score_delta: int = 0         # hits within delta of best vote for LCA
    # multi-mapped reads binned at an ancestor are shared down the tree to
    # descendant leaves (RAMBL semantics), but only within this many ranks:
    # a read binned at depth d joins leaves of depth <= d + bin_share_depth.
    # 10 (= MAX_DEPTH) is unlimited sharing - the exact pre-round-2 rule.
    # Full-DB configs MUST bound it: conserved-region reads that LCA to the
    # root are members of every leaf, which makes all ~1e5 leaves "active"
    # (memory/compute explosion) and crowds real reads out of the capped
    # member tables.
    bin_share_depth: int = 10

    # ---- DP-means clustering ----
    # DP-means spawn threshold lambda as an exact rational num/den so that all
    # distance comparisons are integer (diff * den vs num * ncov) - float
    # rounding must never differ between the NumPy oracle and the f32 TPU path
    dp_lambda_num: int = 3
    dp_lambda_den: int = 10
    dp_spawn_min_orphans: int = 3    # orphans consistent with a seed orphan
                                     # required to spawn a cluster from it
    dp_spawn_scan: int = 8           # orphan seeds examined per iteration
    max_clusters_per_bin: int = 8
    max_poly_cols: int = 64          # polymorphic columns used as features
    # strict polymorphism criteria: sequencing errors (~0.5%/base) must not
    # qualify, or error-seeded clusters proliferate and poison refinement
    # minor-allele fraction threshold as an exact rational num/den: the
    # comparison is minor * den >= num * max(tot, 1), integer-exact on every
    # backend (a float frac in f32 on device vs f64 in the oracle can land on
    # opposite sides of the threshold and break bit-parity)
    poly_minor_frac_num: int = 3
    poly_minor_frac_den: int = 20
    poly_min_minor_count: int = 4
    dp_max_iters: int = 16
    dp_leaf_vmap: int = 16           # leaves vmapped per lax.map step in
                                     # dp_means_leaves (1 = fully sequential);
                                     # bounds the (ch, M, K, P) temporaries
    min_cluster_reads: int = 3       # clusters below this are not assembled

    # ---- consensus / iteration ----
    min_coverage: int = 2            # min pileup depth to call a base
    # a cluster population may override the backbone at a polymorphic column
    # only with >= num/den of the backbone's depth there OR a winning base
    # supported by >= vote_min_abs reads (independent sequencing errors
    # essentially never agree 6 deep at one column, while a low-abundance
    # strain at high coverage easily does)
    vote_min_frac_num: int = 1
    vote_min_frac_den: int = 4
    vote_min_abs: int = 6
    max_assembly_iters: int = 5
    max_genes: int = 64              # max consensus sequences carried per round
    full_len_min: int = 1200         # min length to report a gene "full-length"
    # ---- minor-haplotype gene (frequency phasing; oracle/pipeline.py) ----
    # an unequal-abundance strain pair fragments into per-column clusters
    # (reads cannot link variant columns further apart than a read length);
    # in a 2-haplotype leaf every CLEAR minor allele belongs to the same
    # strain, so one extra gene carries the minor allele at every qualifying
    # column. A column qualifies when its leaf-EXCLUSIVE second allele has
    # count >= vote_min_abs, a unique identity, and a frequency within
    # [frac_num/frac_den, max_num/max_den] of the depth - the upper bound
    # gates out equal-abundance pairs (no frequency signal; clustering owns
    # those) and the lower bound gates out sequencing errors at high depth.
    minorhap_min_cols: int = 2
    minorhap_min_abs: int = 4        # min agreeing minor reads per column
                                     # (independent 0.4% errors essentially
                                     # never agree 4 deep; the frac bound
                                     # dominates at depth >= ~27 anyway)
    minorhap_max_num: int = 1
    minorhap_max_den: int = 3
    minorhap_frac_num: int = 3
    minorhap_frac_den: int = 20
    # NOTE: generalizing the single minor allele to multi-strain frequency
    # BANDS was prototyped and measured to NOT work single-sample: at ~40x
    # leaf depth, strain frequencies .28 and .43 smear into one unsplittable
    # .31-.49 continuum (+-.07 sampling noise per column). Multi-strain
    # recovery needs cross-sample abundance covariation (config-4 cohorts) -
    # see SURVEY.md known gaps.

    # ---- cohort covariation phasing (config 4; oracle/cohort.py) ----
    # Cross-sample abundance covariation separates strains that single-sample
    # frequency phasing provably cannot (measured: at ~40x leaf depth strain
    # allele frequencies smear into one continuum). Per leaf, every qualifying
    # variant column carries a per-sample minor-allele frequency VECTOR;
    # columns cluster by an exact pooled-two-proportion chi-square (DP-means
    # style, Fraction arithmetic - deterministic and integer-exact), and each
    # column group emits one strain gene. tau is the mean per-sample
    # chi-square join threshold (prototyped: tau=3 recovers 98/100 strains at
    # the measured single-sample 19/100 wall shape; 5 samples x 40x depth).
    cohort_phase: bool = True        # enable in multi-sample cohort mode
    cohort_tau_num: int = 3          # join threshold per chi-square df
    cohort_tau_den: int = 1
    cohort_min_depth: int = 8        # per-sample depth for a sample to count
    cohort_min_abs: int = 4          # pooled minor count per qualifying column
    cohort_frac_num: int = 1         # pooled minor fraction lower bound
    cohort_frac_den: int = 50
    cohort_min_cols: int = 2         # min own columns for a group to emit
    cohort_max_cols: int = 512       # cap on phased columns per leaf
    cohort_max_iters: int = 8        # DP-means reassignment iterations

    # ---- polish pass (final leaf-exclusive re-vote; oracle/polish.py) ----
    # a gene base is overridden only by depth >= polish_min_depth votes with a
    # unique winner holding >= maj_num/maj_den of them; mixed strain columns
    # (~50/50) never qualify, contamination/coin-flip errors do
    polish: bool = True
    polish_min_depth: int = 4
    polish_maj_num: int = 2
    polish_maj_den: int = 3
    # fill INTERIOR emit holes at polish time: pileup winner at depth >=
    # polish_min_depth, else the leaf anchor's reference base (the
    # reference-guided gap fill; oracle/polish.py module docstring)
    polish_fill_holes: bool = True
    # extend gene EDGES at polish time over anchor columns with deep
    # leaf-exclusive evidence (depth >= polish_min_depth, non-polymorphic,
    # contiguous outward from the gene span). The r5 config-4 census
    # measured every remaining absent column as an EDGE truncation (left
    # 7-31 cols): emit gates clip low-coverage ends, and each clipped end
    # costs ~k containment k-mers. Evidence-only - no anchor-base
    # fabrication at edges (unlike interior holes, an untouched edge leaves
    # no foreign junction k-mers).
    polish_extend_edges: bool = True

    # ---- batching / parallelism ----
    # node pileups switch from the dense (n_nodes, ref_len, 4) accumulator to
    # slot-compacted active-node accumulators above this node count (a
    # full-Greengenes taxonomy would need terabytes dense; a sample only
    # touches its active leaves' ancestor chains) - pipeline/pileup.py
    pileup_slot_nodes: int = 4096
    # cluster/consensus leaves processed per device call (0 = all at once).
    # The per-leaf tensors are (NL, max_bin_reads, ...): at full-DB scale
    # thousands of leaves can be active, so NL must be blocked to bound
    # memory - leaves are independent, so blocking is bitwise-neutral.
    cluster_leaf_block: int = 0
    max_bin_reads: int = 4096        # member cap per leaf bin for clustering
                                     # (pileups are never capped; features /
                                     # cluster scatter use the first cap
                                     # members by read index)
    # single-device cluster member gather: pack (query, ref_col) retention
    # into one int16 array ((rc+1)*8+q <= 16391 since ref_len_max=2048 and
    # base codes are 0..4) hoisted once per round, so each leaf block does
    # ONE 256B-row gather instead of two (128B int8 + 256B int16) - the
    # gather is descriptor-bound on the TPU. Unpacking after the gather is
    # exact integer arithmetic: bitwise identical members. Costs one extra
    # (B, L) int16 buffer, so the assembly only engages it when
    # B <= packed_member_gather_max_reads.
    packed_member_gather: bool = True
    packed_member_gather_max_reads: int = 12_000_000
    batch_size: int = 1024           # reads per device batch (global)
    mesh_data_axis: str = "data"
    shard_index: bool = False        # False: replicate index; True: ring-sharded
    # transport for the ring-sharded index rotation: "ppermute" = XLA
    # collective (the port: one copy_ a rank and array); "dma" = raw Pallas
    # make_async_remote_copy + DMA semaphores (the port: K4, csrc/ring.cu,
    # one launch a rank into the next rank's buffer, across cards too);
    # "dma_barrier" = dma plus a neighbor entry barrier + collective_id
    # (parallel/ring_dma.py ordering invariant; "dma" and "dma_barrier" run
    # on TPU meshes and CUDA ranks only - all bitwise identical)
    ring_impl: str = "ppermute"
    # merge the streamed pileup accumulators with psum_scatter over the
    # COLUMN axis instead of a full psum (mesh mode only): the collective
    # moves 1/N of the bytes and each device keeps 1/N of the columns - the
    # position-sharded merge for >=100M-read configs (BASELINE config 5)
    # where the (n_nodes, ref_len, 4) all-reduce dominates DCN traffic.
    # Requires ref_len_max % n_devices == 0. Bitwise identical output.
    shard_positions: bool = False

    # ---- misc ----
    seed: int = 0                    # RNG seed for any simulated data

    @property
    def window_len(self) -> int:
        return self.read_len_max + 2 * self.window_margin

    @property
    def n_diag_bins(self) -> int:
        # diagonal = ref_pos - read_pos ranges over [-read_len_max, ref_len_max)
        return (self.ref_len_max + self.read_len_max) // self.diag_bin + 2

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "PipelineConfig":
        d = json.loads(s)
        # legacy float threshold -> exact rational (pre-round-2 checkpoints)
        legacy = d.pop("poly_min_minor_frac", None)
        if legacy is not None and "poly_minor_frac_num" not in d:
            from fractions import Fraction
            f = Fraction(legacy).limit_denominator(10**6)
            d["poly_minor_frac_num"] = f.numerator
            d["poly_minor_frac_den"] = f.denominator
        sc = d.pop("scoring", None)
        cfg = PipelineConfig(**d)
        if sc is not None:
            cfg = dataclasses.replace(cfg, scoring=ScoringParams(**sc))
        return cfg


def _preset(**kw) -> PipelineConfig:
    return PipelineConfig(**kw)


# The five BASELINE configs (BASELINE.json:6-12). Sizes here parameterize the
# *pipeline*; dataset sizes live with the dataset generators / CLI args.
# All presets set sw_rows=104: the BASELINE workloads are 100bp reads, and the
# truncated wavefront is proven exact whenever every read fits (the host
# boundary raises loudly otherwise - set sw_rows=0 for longer reads).
_SW_ROWS_100BP = 104
PRESETS = {
    # 1. Toy mock community: 10k x 100bp reads vs 100-seq Greengenes subset.
    "toy": _preset(batch_size=1024, max_genes=16, sw_rows=_SW_ROWS_100BP),
    # 2. Small mock community: ~20 taxa, 1M reads, single host.
    "small": _preset(batch_size=8192, max_genes=64, sw_rows=_SW_ROWS_100BP),
    # 3. Human gut metagenome: ~10M reads vs full Greengenes, single host.
    # max_genes must exceed the present-taxa count (a gut sample carries
    # hundreds of species): the r3 1M x 100k run with 500 present refs
    # saturated 256 slots and capped recovery at 129/500.
    "gut": _preset(batch_size=16384, max_genes=1024, max_clusters_per_bin=16,
                   bin_share_depth=3, sw_rows=_SW_ROWS_100BP),
    # 4. Multi-sample cohort: 5 metagenomes, shared sharded index.
    "cohort": _preset(batch_size=16384, max_genes=256, shard_index=True,
                      sw_rows=_SW_ROWS_100BP),
    # 5. Deep metagenome: >=100M reads, N>=2 hosts, sharded index + psum merge
    #    (position-sharded: the pileup merge rides reduce-scatter, B:11).
    "deep": _preset(batch_size=32768, max_genes=1024, shard_index=True,
                    max_clusters_per_bin=16, bin_share_depth=3,
                    sw_rows=_SW_ROWS_100BP, shard_positions=True),
}
