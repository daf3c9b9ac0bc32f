"""Model substrate: layers, attention, the recurrent cores (``ssm``) and
the model assembly for all six families, dense, moe, ssm, hybrid, vlm and
audio (init / loss / prefill / decode / chunked prefill / paged decode),
the MoE FFN (``moe``), plus the weight bridge from the reference
package."""
from .bridge import params_from_numpy  # noqa: F401
from .layers import Param, merge_params, split_params  # noqa: F401
from .transformer import (  # noqa: F401
    chunk_prefill_fn,
    decode_fn,
    init_cache,
    init_params,
    layer_pattern,
    loss_fn,
    paged_chunk_prefill_fn,
    paged_decode_fn,
    prefill_fn,
    resolve_device,
    supports_paged_stack,
    torch_dtype,
)
