from portbench.reference.h264.entropy.cavlc import (
    read_coeff_token, write_coeff_token,
    read_residual_block, write_residual_block,
)

__all__ = [
    "read_coeff_token", "write_coeff_token",
    "read_residual_block", "write_residual_block",
]
