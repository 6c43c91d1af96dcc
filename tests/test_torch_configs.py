"""The port's config registry against the reference's: every field of
every FULL and SMOKE config of all 11 architectures (the ten assigned
and the paper's llama2-7b), and each FULL model's parameter count
(``lm.param_count`` on the ``meta`` device against the reference's
``eval_shape``)."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro_torch import configs
from repro_torch.models import lm

ALL = ref_configs.ARCH_IDS + ref_configs.EXTRA_IDS


def test_registry_holds_every_reference_architecture():
    assert sorted(configs.ARCH_IDS) == sorted(ALL)
    assert len(ALL) == 11


@pytest.mark.parametrize("smoke", [False, True], ids=("full", "smoke"))
@pytest.mark.parametrize("arch", ALL)
def test_config_fields_equal_reference(arch, smoke):
    ref = ref_configs.get(arch, smoke=smoke)
    port = configs.get(arch, smoke=smoke)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "dtype":
            assert jnp.dtype(a).name == str(b).rsplit(".", 1)[-1]
        else:
            assert a == b, f.name
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]


@pytest.mark.parametrize("arch", ALL)
def test_param_count_equals_reference(arch):
    n = lm.param_count(configs.get(arch))
    assert n == ref_lm.param_count(ref_configs.get(arch))
    if arch == "qwen2_vl_2b":        # tied: one (V, D) table, no lm_head
        assert n == 1_543_656_960
    if arch == "hubert_xlarge":      # no token table
        assert n == 944_487_680
