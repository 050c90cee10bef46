from .pca import pca, flashpca, PCAResult
from .check import check, CheckResult
from .project import project, ProjectResult
from .ucca import ucca, UccaResult
