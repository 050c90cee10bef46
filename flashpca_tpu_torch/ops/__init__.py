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
    DenseOperator,
    PackedOperator,
    StreamingPackedOperator,
    TallPackedOperator,
    TallStreamingOperator,
    build_packed_operator,
    check_operator_conflicts,
    default_dtype,
    packed_operator_from_numpy,
    resolve_streaming,
    streaming_operator_from_numpy,
    tall_operator_from_numpy,
    tall_streaming_operator_from_numpy,
)
