from .plink import (
    PlinkDataset,
    bytes_per_snp,
    unpack_codes,
    codes_to_dosage,
    snp_stats_from_codes,
    write_bed,
    pack_codes,
    subset_samples,
    PACK_DENSITY,
)
from .text import (
    read_text,
    read_text_with_rownames,
    read_maf,
    maf2meansd,
    save_text,
    TXT_SEP,
)
