"""gpr_tpu — accelerator-native Gaussian Process inference engine.

A from-scratch JAX/XLA rebuild of the full capability surface of the
reference C++ library agiger/GPR (see SURVEY.md): composable kernels with
hyperparameter gradients, exact and sparse (inducing-point) GP regression,
Gaussian (log-)likelihoods, prior densities, MAP/MLE and HMC/NUTS
hyperparameter inference, PCA + autoregressive feature pipelines, and
train/predict CLI apps — designed for an accelerator (GEMM Gram
construction, Cholesky solves, shard_map scale-out) rather than as a port.
"""

from .kernels.kernels import (  # noqa: F401
    Constant,
    Gaussian,
    GaussianARD,
    GaussianExp,
    Matern12,
    Matern32,
    Matern52,
    Kernel,
    Linear,
    Periodic,
    Product,
    RationalQuadratic,
    Sum,
    White,
    gram,
    gram_derivative,
    kvec,
    params_vector,
)
from .kernels.dsl import kernel_to_string, parse_kernel  # noqa: F401
from .kernels.utils import get_general_kernel  # noqa: F401
from .gp.exact import GP, extend, fit, load, shrink  # noqa: F401
from .gp.sparse import SparseGP, fit_sparse, fit_svgp  # noqa: F401
from .gp.batched import fit_batched, mll_batched, predict_batched  # noqa: F401
from .gp import likelihood  # noqa: F401
from .inference.optimize import fit_map, fit_mle  # noqa: F401
from .inference.hmc import HMCConfig, sample_hmc, sample_hmc_chunked  # noqa: F401
from .inference.nuts import NUTSConfig, sample_nuts, sample_nuts_chunked  # noqa: F401
from .utils import config  # noqa: F401

__version__ = "0.1.0"
