"""prost_tpu_torch — the PyTorch / CUDA port of prost_tpu, a framework for
large-scale convex-concave saddle-point problems with proximal structure:

    min_x max_y  g(x) + <Kx, y> - f*(y)

The package mirrors ``prost_tpu``'s modules and names.  It imports torch
and never jax (nor ``prost_tpu``).  It holds the modeling API with the
debug entry points (``eval_prox``, ``eval_linop``, ``get_all_variables``),
the linop zoo (gradients, convolution, sparse, dense, diagonal, kron and
zero blocks) and the prox zoo (scalar, norm, simplex, spectral, cone,
epigraph, index-set, range, transform and permutation proxes), the
preconditioned Problem, the C++ host runtime for problem assembly
(``_native``, built by g++ on first use), the generic PDHG backend with
all four step-size rules, the generic ADMM backend with CGLS, Chebyshev
and DCT projections, the solver loop, and the fused routes for ROF-type
denoising, the fast and tight multilabel relaxations, TV deblurring,
volumetric TV and ADMM on ROF, whose chunk kernels are hand-written CUDA
for Hopper (``csrc/*.cu``), built by nvcc on first use.
``prost_tpu_torch.parallel`` solves batched ensembles of B instances of
one structure on one card (``BatchedPDHG``, ``stack_problems``) through
batched chunk kernels, and shards one problem's pixel rows over the ranks
of a ``torch.distributed`` group (``make_mesh``, ``ShardedPDHG``, and the
halo-exchange routes on the halo chunk kernels).  ``modeling.wire``
serializes problems to the JAX package's JSON spec and back;
``util`` checkpoints solver states and profiles; ``entry`` holds the
compile and launch checks; ``examples`` the 14 example scripts
(``python -m prost_tpu_torch.examples.<name>``); ``docs`` writes the API
pages.
"""

from .config import (ProstError, device, dtype, list_devices, set_device,
                     set_dtype)
from .problem import Problem, SCALING_ALPHA, SCALING_CUSTOM, SCALING_IDENTITY
from .solver import ConvergenceResult, Solver, SolverOptions, SolverResult
from .modeling import (
    MinMaxProblem,
    MinProblem,
    SubVariable,
    Variable,
    backend_admm,
    backend_pdhg,
    eval_linop,
    eval_prox,
    get_all_variables,
    options,
    solve,
)
from .modeling import block, function

__version__ = "0.1.0"

__all__ = [
    "ProstError",
    "dtype",
    "set_dtype",
    "device",
    "list_devices",
    "set_device",
    "Problem",
    "SCALING_ALPHA",
    "SCALING_CUSTOM",
    "SCALING_IDENTITY",
    "ConvergenceResult",
    "Solver",
    "SolverOptions",
    "SolverResult",
    "Variable",
    "SubVariable",
    "MinMaxProblem",
    "MinProblem",
    "solve",
    "options",
    "backend_pdhg",
    "backend_admm",
    "eval_prox",
    "eval_linop",
    "get_all_variables",
    "function",
    "block",
    "__version__",
]
