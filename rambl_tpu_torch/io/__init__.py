"""Host-side sequence I/O (copies of rambl_tpu.io)."""

from rambl_tpu_torch.io.fasta import (  # noqa: F401
    read_fasta,
    read_fastq,
    write_fasta,
    write_fastq,
)
from rambl_tpu_torch.io.pack import (  # noqa: F401
    BASE_TO_CODE,
    CODE_TO_BASE,
    decode_seq,
    encode_batch,
    encode_seq,
    pack_2bit,
    revcomp_codes,
    unpack_2bit,
)
