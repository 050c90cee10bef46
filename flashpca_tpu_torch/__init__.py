"""flashpca_tpu_torch: the PyTorch/CUDA port of flashpca_tpu.

Biobank-scale genotype PCA on one NVIDIA Hopper card: PLINK IO and
per-SNP standardization on the host, the packed-genotype operator with
hand-written CUDA kernels for its fused decode->product passes
(kernels/csrc/), the thick-restart block Lanczos solver with its
compensated (two-float) refinement, ``pca``, ``check`` and the
flag-compatible CLI.  Imports ``torch`` (never JAX); entry points run on
``cuda`` unless given ``device="cpu"``.
"""

__version__ = "0.1.0"

from .io import PlinkDataset
from .ops import PackedOperator, packed_operator_from_numpy, standardize
from .models import pca, PCAResult, check, CheckResult
from .solvers import eigsh, eigsh_block, EigshResult
