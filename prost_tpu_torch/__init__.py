"""prost_tpu_torch — the PyTorch / CUDA port of prost_tpu, a framework for
large-scale convex-concave saddle-point problems with proximal structure:

    min_x max_y  g(x) + <Kx, y> - f*(y)

The package mirrors ``prost_tpu``'s modules and names.  It imports torch
and never jax (nor ``prost_tpu``).  Slices 1-6 cover ROF-type denoising
by PDHG and by graph-projection ADMM, the fast and tight multilabel
relaxations, TV deblurring and volumetric TV: the modeling API, the prox
and linop parts they use, the preconditioned Problem, the generic PDHG
backend with all four step-size rules, the generic ADMM backend with CGLS,
Chebyshev and DCT projections, the solver loop, and the fused routes,
whose chunk kernels are hand-written CUDA for Hopper (``csrc/*.cu``),
built by nvcc on first use.  ``prost_tpu_torch.parallel`` (slices 7-8a)
solves batched ensembles of B instances of one structure on one card
(``BatchedPDHG``, ``stack_problems``) through batched chunk kernels, and
shards one problem's pixel rows over the ranks of a ``torch.distributed``
group (``make_mesh``, ``ShardedPDHG``, and the halo-exchange ROF,
multilabel and volumetric-TV routes on the halo chunk kernels).
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
    "function",
    "block",
    "__version__",
]
