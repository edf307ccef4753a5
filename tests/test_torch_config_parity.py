"""Every config dataclass of the port against its JAX twin: the same field
names with the same defaults (a default factory's value compared), so that
a config built from one package's fields by name builds the other's."""

import dataclasses
import importlib

import pytest

PAIRS = [  # (module under both packages, class)
    ("models.qwen2", "LLMConfig"),
    ("models.siglip", "SigLIPConfig"),
    ("models.vlm", "VLMConfig"),
    ("models.projector", "ProjectorConfig"),
    ("train.trainer", "TrainArgs"),
    ("train.optimizer", "OptimizerConfig"),
    ("parallel.sp", "SPConfig"),
    ("models.ps3", "PS3Config"),
    ("models.vit", "ViTConfig"),
    ("train.lora", "LoRAConfig"),
    ("train.dpo", "DPOConfig"),
    ("train.rlhf", "PPOConfig"),
]

REQUIRED = "<required>"


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            value = f.default
        elif f.default_factory is not dataclasses.MISSING:
            value = f.default_factory()
        else:
            value = REQUIRED
        out[f.name] = value
    return out


@pytest.mark.parametrize("module,name", PAIRS, ids=[p[1] for p in PAIRS])
def test_config_fields_and_defaults_match_jax(module, name):
    want = getattr(importlib.import_module("vila_tpu." + module), name)
    got = getattr(importlib.import_module("vila_tpu_torch." + module), name)
    assert _defaults(got) == _defaults(want)
