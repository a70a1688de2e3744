"""The port's config registry against the reference's: every field, every arch."""

import dataclasses

import pytest
import torch

from repro import configs as ref
from repro_torch import configs as port


def _pair(arch, which):
    get_ref = ref.get_config if which == "CONFIG" else ref.get_smoke_config
    get_port = port.get_config if which == "CONFIG" else port.get_smoke_config
    return get_ref(arch), get_port(arch)


def _derived(cfg, attr):
    """A derived property, or the name of what it raises (mamba2 has no
    attention heads, so its head dim divides by zero in both packages)."""
    try:
        return getattr(cfg, attr)
    except ArithmeticError as err:
        return type(err).__name__


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ref.ARCH_IDS)
def test_every_field_equals_reference(arch, which):
    r, p = _pair(arch, which)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert _dtype_name(p.param_tdtype()) == r.param_jdtype().name
    assert _dtype_name(p.compute_tdtype()) == r.compute_jdtype().name
    for attr in ("resolved_head_dim", "padded_vocab", "superblock_period"):
        assert _derived(p, attr) == _derived(r, attr), attr
    assert p.param_count() == r.param_count()
    assert p.param_count(active_only=True) == r.param_count(active_only=True)
    assert [p.layer_is_attn(i) for i in range(p.n_layers)] == [
        r.layer_is_attn(i) for i in range(r.n_layers)
    ]
    assert [p.layer_is_moe(i) for i in range(p.n_layers)] == [
        r.layer_is_moe(i) for i in range(r.n_layers)
    ]
    assert port.applicable_shapes(p) == ref.applicable_shapes(r)


def test_registry_and_shapes_equal_reference():
    assert port.ARCH_IDS == ref.ARCH_IDS
    assert port.list_archs() == ref.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in port.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref.SHAPES.items()
    }
    assert {k: v.tokens for k, v in port.SHAPES.items()} == {
        k: v.tokens for k, v in ref.SHAPES.items()
    }


def test_unknown_arch_and_dtype_raise():
    with pytest.raises(KeyError):
        port.get_config("no-such-arch")
    with pytest.raises(ValueError):
        port.torch_dtype("no_such_dtype")
    assert port.torch_dtype("float8_e4m3fn") == torch.float8_e4m3fn
