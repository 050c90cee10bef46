from .pca import pca, flashpca, PCAResult
from .check import check, CheckResult
from .project import project, ProjectResult
from .ucca import ucca, wilks, UccaResult
from .scca import (scca, scca_grid, SCCAResult, SCCAGridResult,
                   save_scca_state, load_scca_state, soft_thresh,
                   norm_thresh, make_gaussian, cv_scca, CVSCCAResult,
                   grid_fastpath)
from .scca_split import split_scca, SplitSCCAResult
