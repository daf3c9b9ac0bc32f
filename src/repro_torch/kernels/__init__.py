"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, built with nvcc
and bound through ctypes) with their plain PyTorch versions and the
device dispatch (``ops.py``: ``ops.rms_norm``, ``ops.add_rms_norm``,
``ops.paged_decode_attention``, ``ops.decode_attention``,
``ops.ssm_chunk_scan``, ``ops.swap_best``).  The submodules ``rms_norm``,
``paged_attention``, ``decode_attention``, ``ssm_scan`` and ``bfio_swap``
hold each wrapper with its launch counter."""
from .ops import on_cuda, paged_decode_attention  # noqa: F401
from .paged_attention import (  # noqa: F401
    paged_decode_attention_plain,
    paged_decode_attention_ref,
)
from .bfio_swap import swap_best_dense, swap_best_plain  # noqa: F401
from .decode_attention import decode_attention_plain  # noqa: F401
from .rms_norm import add_rms_norm_plain, rms_norm_plain  # noqa: F401
from .ssm_scan import ssm_chunk_scan_plain  # noqa: F401
