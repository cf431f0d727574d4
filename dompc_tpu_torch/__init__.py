"""dompc_tpu_torch — the PyTorch / CUDA port of dompc_tpu.

Same module names and public names as the JAX package (``dm.model.Model``,
``dm.controller.MPC``, ``mpc.settings``, ``mpc.bounds[...]``,
``mpc.scaling[...]``); the numerics run as eager PyTorch with
``torch.func`` transforms, and the KKT chain sweep runs in a hand-written
CUDA kernel (``solver/band_qr.py``, ``csrc/band_qr.cu``).  The closed loop
has ``dm.Simulator`` and ``dm.estimator.EKF``; the satellites
``dm.sampling``, ``dm.differentiator``, ``dm.approximateMPC`` (a
``torch.nn`` policy) and ``dm.graphics`` (matplotlib, imported when
drawing) come with the package, and so do ``dm.parallel``'s sharded
serving over ``torch.distributed``, ``dm.tools.profiler``'s trace capture,
``dm.opcua`` (the network client and server need ``asyncua``) and
``dm.sysid`` (imported here when ``onnx`` is installed).

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
from . import ops  # noqa: E402
from .simulator import Simulator  # noqa: E402
from . import estimator  # noqa: E402
from . import systems  # noqa: E402
from . import parallel  # noqa: E402
from . import sampling  # noqa: E402
from . import differentiator  # noqa: E402
from . import graphics  # noqa: E402
from . import approximateMPC  # noqa: E402

# optional-dependency gates (reference: do_mpc/__init__.py:79-95)
try:
    import onnx as _onnx  # noqa: F401
    __ONNX_INSTALLED__ = True
    from . import sysid  # noqa: F401
except ImportError:
    __ONNX_INSTALLED__ = False

try:
    import asyncua as _asyncua  # noqa: F401
    __ASYNCUA_INSTALLED__ = True
except ImportError:
    __ASYNCUA_INSTALLED__ = False
# namespace/tag plumbing is importable without asyncua (RTClient/RTServer
# are None in that case)
from . import opcua  # noqa: E402

__version__ = "0.1.0"
