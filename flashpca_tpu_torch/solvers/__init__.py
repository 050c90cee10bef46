from .lanczos import EigshResult, eigsh, save_state, load_state
from .block_lanczos import eigsh_block, polish_subspace

__all__ = [
    "EigshResult",
    "eigsh",
    "eigsh_block",
    "polish_subspace",
    "save_state",
    "load_state",
]
