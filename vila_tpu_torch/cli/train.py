"""`vila-train` flags, as `vila_tpu/cli/train.py`: the stage presets
(align / stage15 / pretrain / sft tune flags and learning rates of
scripts/NVILA-Lite/*.sh) and the parser over `TrainArgs`.

`main` (load `--model-path`, build the dataset and collator, train) waits
for the loader (`entry.load`); until then a caller builds a `Trainer` over
its own parameters.
"""

from __future__ import annotations

import argparse
import dataclasses

from vila_tpu_torch.train.trainer import TrainArgs

STAGE_PRESETS = {
    # mirror scripts/NVILA-Lite/{align,stage15,pretrain,sft}.sh tune flags
    "align": dict(
        tune_language_model=False,
        tune_vision_tower=False,
        tune_mm_projector=True,
        learning_rate=1e-3,
    ),
    "stage15": dict(
        tune_language_model=False,
        tune_vision_tower=True,
        tune_mm_projector=True,
        learning_rate=5e-5,
    ),
    "pretrain": dict(
        tune_language_model=True,
        tune_vision_tower=False,
        tune_mm_projector=True,
        learning_rate=5e-5,
    ),
    "sft": dict(
        tune_language_model=True,
        tune_vision_tower=True,
        tune_mm_projector=True,
        learning_rate=2e-5,
        vision_tower_lr=2e-6,
    ),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vila-train")
    p.add_argument("--model-path", required=True,
                   help="component checkpoint dir (llm/, vision_tower/, mm_projector/)")
    p.add_argument("--stage", choices=sorted(STAGE_PRESETS), default=None)
    for f in dataclasses.fields(TrainArgs):
        name = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=f.default)
        else:
            p.add_argument(name, type=_flag_type(f), default=f.default)
    return p


def _flag_type(f: dataclasses.Field):
    """The flag's parser: the default's type, or for an Optional field
    without default the annotated one (the JAX parser reads those as str,
    so `--vision-tower-lr 2e-6` became a string there)."""
    if f.default is not None:
        return type(f.default)
    for name, typ in (("float", float), ("int", int)):
        if name in str(f.type):
            return typ
    return str


def train_args(ns: argparse.Namespace) -> TrainArgs:
    """The parsed flags as `TrainArgs`, the stage preset applied last."""
    kw = {f.name: getattr(ns, f.name) for f in dataclasses.fields(TrainArgs)}
    if ns.stage:
        kw.update(STAGE_PRESETS[ns.stage])
    return TrainArgs(**kw)
