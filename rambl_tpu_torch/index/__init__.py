"""Seed index, taxonomy tables and column maps (copies of rambl_tpu.index)."""

from rambl_tpu_torch.index.builder import (  # noqa: F401
    SeedIndex,
    build_seed_index,
)
from rambl_tpu_torch.index.taxonomy import (  # noqa: F401
    TaxonomyTables,
    build_taxonomy_tables,
)
