from .pca import pca, PCAResult
from .check import check, CheckResult
