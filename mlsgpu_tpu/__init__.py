"""mlsgpu_tpu — surface reconstruction from massive point clouds on GPUs.

A ground-up JAX/XLA re-design of the capabilities of bmerry/mlsgpu
(moving-least-squares implicit surfaces + marching tetrahedra over out-of-core
point clouds). See DESIGN.md for the architecture and SURVEY.md for the
reference analysis.
"""

__version__ = "0.1.0"

from mlsgpu_tpu.core.grid import Grid
from mlsgpu_tpu.core.splat import SplatArray
from mlsgpu_tpu.config import ReconstructConfig

__all__ = ["Grid", "SplatArray", "ReconstructConfig", "__version__"]
