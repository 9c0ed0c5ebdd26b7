"""Batched board operations in PyTorch: encoding, validation, propagation,
search, and the CUDA kernel's wrapper."""

from .spec import BoardSpec, SPEC_9, SPEC_16, SPEC_25, spec_for_size
from .validate import (
    check_boards,
    check_rows,
    check_cols,
    check_boxes,
    is_valid_move,
)
from .propagate import analyze, propagate, propagate_step
from .solver import SolveResult, solve_batch
from .cuda_solver import solve_batch_cuda
from .config import SERVING_CONFIG, serving_config

__all__ = [
    "BoardSpec",
    "SPEC_9",
    "SPEC_16",
    "SPEC_25",
    "spec_for_size",
    "check_boards",
    "check_rows",
    "check_cols",
    "check_boxes",
    "is_valid_move",
    "analyze",
    "propagate",
    "propagate_step",
    "solve_batch",
    "solve_batch_cuda",
    "SolveResult",
    "SERVING_CONFIG",
    "serving_config",
]
