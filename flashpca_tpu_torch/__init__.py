"""flashpca_tpu_torch: the PyTorch/CUDA port of flashpca_tpu.

Biobank-scale genotype PCA on one NVIDIA Hopper card: PLINK IO and
per-SNP standardization on the host, the packed-genotype operator with
hand-written CUDA kernels for its fused decode->product passes
(kernels/csrc/), the thick-restart block Lanczos solver with its
compensated (two-float) refinement, ``pca`` on the wide (X X^T) or the
tall (X^T X) gram -- each also streamed from the host under a
device-memory bound -- or on a numeric matrix held whole
(``DenseOperator``), with mid-run checkpoints; ``check``, ``project``
(new samples onto loadings), ``ucca`` (per-SNP multivariate ANOVA),
``scca`` and ``scca_grid`` (sparse CCA, one run or a whole penalty grid
through shared passes, with per-dimension checkpoints), ``cv_scca`` and
``split_scca`` (penalty selection by k-fold CV or a train/test split,
PLINK filesets repacked per split), ``plots`` and the
flag-compatible CLI, at float32 (the kernels) or float64 (the PyTorch
functional core, on the card or the CPU); every packed operator and
entry point also shards over several cards or processes (``mesh=``,
``flashpca_tpu_torch.parallel`` on ``torch.distributed``).  Imports
``torch`` (never JAX); entry points run on ``cuda`` unless given
``device="cpu"``.
"""

__version__ = "0.1.0"

from .io import PlinkDataset
from .ops import (DenseOperator, PackedOperator, StreamingPackedOperator,
                  TallPackedOperator, TallStreamingOperator,
                  packed_operator_from_numpy, resolve_streaming, scale2,
                  standardize, streaming_operator_from_numpy,
                  tall_operator_from_numpy,
                  tall_streaming_operator_from_numpy)
from .models import (pca, flashpca, PCAResult, check, CheckResult, project,
                     ProjectResult, ucca, UccaResult, scca, scca_grid,
                     SCCAResult, SCCAGridResult, save_scca_state,
                     load_scca_state, soft_thresh, norm_thresh, cv_scca,
                     CVSCCAResult, split_scca, SplitSCCAResult)
from .solvers import eigsh, eigsh_block, EigshResult
from . import plots  # matplotlib itself loads lazily inside plots
