"""dompc_tpu_torch — the PyTorch / CUDA port of dompc_tpu.

Same module names and public names as the JAX package (``dm.model.Model``,
``dm.controller.MPC``, ``mpc.settings``, ``mpc.bounds[...]``,
``mpc.scaling[...]``); the numerics run as eager PyTorch with
``torch.func`` transforms, and the KKT chain sweep runs in a hand-written
CUDA kernel (``solver/band_qr.py``, ``csrc/band_qr.cu``).

Environment (read when an MPC is set up, never at import):

* ``DOMPC_TPU_PLATFORM=cpu`` runs on the CPU; otherwise the port runs on
  ``cuda`` and raises if CUDA is absent — there is no silent CPU path.
* ``DOMPC_TPU_X64=1`` selects float64; the default is float32.
"""
import torch as _torch

# TF32 keeps ~3 decimal digits: the same cliff bf16-grade matmuls were on
# the TPU (see the JAX package's matmul-precision guard).  Full float32
# contractions are the framework default.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from ._config import resolve_device, resolve_dtype  # noqa: E402
from . import sym  # noqa: E402
from . import tools  # noqa: E402
from . import model  # noqa: E402
from . import data  # noqa: E402
from . import optimizer  # noqa: E402
from . import solver  # noqa: E402
from . import controller  # noqa: E402
from . import systems  # noqa: E402
from . import parallel  # noqa: E402

__version__ = "0.1.0"
