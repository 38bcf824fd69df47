"""Data parallelism over a mesh of ranks in one process (`mesh`), the
ring-sharded seed index (`ring`) with its rotation K4 (`ring_dma`), and the
stream's data-parallel steps (`steps`)."""
