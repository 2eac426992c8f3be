from .validation import (
    AVAILABLE_REYNOLDS,
    centerline_profiles,
    get_ghia_data,
    infinity_norm_error,
    l2_norm_error,
    validate_against_benchmark,
)
