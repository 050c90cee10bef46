from .standardize import (
    standardize,
    standardize_transpose,
    scale2,
    lookup_tables,
    VAR_TOL,
    METHOD_CODES,
)
from .genotypes import (
    permute_samples,
    unpermute_samples,
    decode_standardized,
    dense_standardized_np,
    valid_mask_permuted,
)
from .operator import (
    PackedOperator,
    TallPackedOperator,
    build_packed_operator,
    check_operator_conflicts,
    packed_operator_from_numpy,
    tall_operator_from_numpy,
)
