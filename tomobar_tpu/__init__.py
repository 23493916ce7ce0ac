"""tomobar_tpu — tomographic model-based reconstruction in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of ToMoBAR
(dkazanc/ToMoBAR): direct (FBP, Fourier) and regularised iterative (FISTA,
ADMM, CGLS, SIRT, Landweber, OSEM) reconstruction of parallel-beam 2D/3D
tomography data on NVIDIA GPUs (Pallas kernels for the projector), one
card or a device mesh (sharded detY slabs x angle subsets).

Reference-compatible entry points:

>>> from tomobar_tpu import RecToolsDIR, RecToolsIRTPU
"""

from tomobar_tpu.geometry import Geometry
from tomobar_tpu.models.direct import RecToolsDIR, RecToolsDIRTPU
from tomobar_tpu.models.iterative import RecToolsIRTPU

# Drop-in aliases matching the reference class names so user code ports
# unchanged ("CuPy" classes are the device-resident ones).
RecToolsDIRCuPy = RecToolsDIRTPU
RecToolsIRCuPy = RecToolsIRTPU

__version__ = "0.1.0"

__all__ = [
    "Geometry",
    "RecToolsDIR",
    "RecToolsDIRTPU",
    "RecToolsDIRCuPy",
    "RecToolsIRTPU",
    "RecToolsIRCuPy",
]
