"""textblaster_tpu_torch — the PyTorch/CUDA port of ``textblaster_tpu``.

The JAX package beside it is the reference this port is held against, bit
for bit: the same Parquet in gives the same kept and excluded Parquet out.
The port runs on an NVIDIA GPU (Hopper, ``sm_90a``) with hand-written CUDA
kernels in ``csrc/`` where the JAX package has Pallas kernels; every other
device function is plain PyTorch.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.

Layer map:

* :mod:`.data_model`, :mod:`.errors`, :mod:`.config`, :mod:`.io`,
  :mod:`.filters` (the host oracle), :mod:`.executor`,
  :mod:`.orchestration`, :mod:`.models` — jax-free host modules, copied
  from the JAX package.
* :mod:`.ops` — the device path: packing, the ported statistic functions,
  the kernel wrappers (:mod:`.ops.scan`, :mod:`.ops.sort`) and the
  pipeline (:mod:`.ops.pipeline`).
* :mod:`.kernels` — builds ``csrc/*.cu`` with ``nvcc`` at first use.
* :mod:`.resilience` — retry, split and host ladder, breaker, faults,
  watchdog, dead-letter file.
* :mod:`.utils` — host helpers; the metrics registry, ``/metrics`` and the
  run report (:mod:`.utils.metrics`); logging (:mod:`.utils.logging_setup`).
* :mod:`.runner`, :mod:`.cli` — ``python -m textblaster_tpu_torch run``.
"""

__version__ = "0.1.0"

from .data_model import ProcessingOutcome, TextDocument  # noqa: F401
from .errors import (  # noqa: F401
    ConfigError,
    ConfigValidationError,
    DocumentFiltered,
    PipelineError,
    StepError,
)
from .executor import PipelineExecutor, ProcessingStep  # noqa: F401
