"""The port's input shapes (repro_torch.configs.shapes) against the
reference's.

``input_specs`` returns meta-device tensors where the reference returns
``jax.ShapeDtypeStruct``s: for every arch x shape (10 x 4) the spec tree
has the reference's keys, and every leaf its shape and dtype (decode's
cache is ``init_cache`` on the meta device, the audio cache included).
Neither side allocates: the reference traces ``init_cache`` with
``jax.eval_shape``.
"""
import dataclasses

import jax
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import config_for_shape as jax_config_for_shape
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro_torch.configs import (
    LONG_CONTEXT_WINDOW,
    SHAPES,
    config_for_shape,
    get_config,
    get_shape,
    input_specs,
    list_archs,
)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_reference(arch, shape):
    want = list(_leaves(jax_input_specs(jax_get_config(arch),
                                        JAX_SHAPES[shape])))
    got = list(_leaves(input_specs(get_config(arch), SHAPES[shape])))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, j) in zip(got, want):
        assert isinstance(j, jax.ShapeDtypeStruct)
        assert t.device.type == "meta", path
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path


def test_shapes_and_config_for_shape_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for arch in list_archs():
        for name in SHAPES:
            got = config_for_shape(get_config(arch), SHAPES[name])
            want = jax_config_for_shape(jax_get_config(arch),
                                        JAX_SHAPES[name])
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    windowed = {a for a in list_archs()
                if config_for_shape(get_config(a), SHAPES["long_500k"]
                                    ).sliding_window == LONG_CONTEXT_WINDOW}
    assert "whisper-tiny" in windowed and "zamba2-1.2b" not in windowed


def test_get_shape():
    assert get_shape("decode_32k") is SHAPES["decode_32k"]
    with pytest.raises(KeyError, match="unknown shape"):
        get_shape("decode_64k")


def test_decode_specs_allocate_nothing():
    """The largest decode cache (qwen2-72b at decode_32k) stays on meta."""
    specs = input_specs(get_config("qwen2-72b"), SHAPES["decode_32k"])
    k = specs["cache"]["blocks"]["k"]
    assert k.is_meta and k.dtype == torch.bfloat16
    assert k.numel() * k.element_size() > 5e11       # 550 GB if real
