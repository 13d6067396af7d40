from .domain import Domain, domain
from .ntt import (
    NTT,
    four_step_input_perm,
    four_step_ntt,
    four_step_output_perm,
    ntt,
)
