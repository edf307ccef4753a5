"""`vila-train`, as `vila_tpu/cli/train.py`: the stage presets (align /
stage15 / pretrain / sft tune flags and learning rates of
scripts/NVILA-Lite/*.sh), the parser over `TrainArgs`, and `main`: load
`--model-path` (tokenizer, config, weights), build the dataset mixture and
the collator, train.

    python -m vila_tpu_torch.cli.train --model-path ckpt/ --stage sft \
        --data-mixture dummy_mix --max-steps 100 [--device cuda]

On N cards, one process each (torchrun's environment; dp x sp x su = N):

    torchrun --nproc_per_node=N -m vila_tpu_torch.cli.train --distributed true \
        --sp N --model-path ckpt/ --stage sft ...

The weights are loaded as f32 master weights (the `Trainer`'s contract);
the compute dtype is the config's (bf16 on the card, f32 on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

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
    p.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from vila_tpu_torch.data.builder import build_dataset
    from vila_tpu_torch.data.collate import Collator, PackingCollator
    from vila_tpu_torch.entry import build_config, load_params, load_tokenizer
    from vila_tpu_torch.train.trainer import Trainer

    targs = train_args(args)
    if targs.distributed:  # before loading: each rank's card is LOCAL_RANK's
        from vila_tpu_torch.parallel.distributed import init_distributed

        init_distributed(backend="gloo" if args.device == "cpu" else None)
    tokenizer = load_tokenizer(args.model_path)
    cfg = build_config(args.model_path, device=args.device)
    params = load_params(args.model_path, cfg, param_dtype=torch.float32,
                         device=args.device)

    dataset = build_dataset(targs.data_mixture, tokenizer, cfg)
    # zigzag ring layout needs S % (2 * sp * su) == 0
    seq_mult = max(targs.sp * targs.su, 1)
    if targs.sp_attention and targs.ring_layout == "zigzag" and targs.sp > 1:
        seq_mult *= 2
    common = dict(seq_len=targs.seq_len, pad_token_id=tokenizer.pad_token_id or 0,
                  seq_multiple=seq_mult, tile_size=cfg.vision.image_size)
    if targs.pack_rows > 0:
        collator = PackingCollator(rows=targs.pack_rows, **common)
    else:
        collator = Collator(**common)
    Trainer(cfg, params, dataset, collator, targs, device=args.device).train()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
