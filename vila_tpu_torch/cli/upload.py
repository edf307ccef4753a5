"""`vila-torch-upload`, as `vila_tpu/cli/upload.py`: push a checkpoint to
the Hugging Face Hub.

    vila-torch-upload ckpt/ org/model [--private] [--branch main] \\
        [--token T] [--remote-code] [--device cuda]

Capability parity: llava/cli/upload2hf.py. The component checkpoint
(`llm/`, `vision_tower/`, `mm_projector/` and the top-level config) is
uploaded as it is; with `--remote-code` it is first loaded (on `--device`,
the card unless `cpu` is asked for) and converted into the single-repo
`trust_remote_code` artifact (`export.export_hf_repo`), which is uploaded
instead. The upload itself is `huggingface_hub`'s.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vila-torch-upload")
    p.add_argument("checkpoint", help="component checkpoint directory")
    p.add_argument("repo_id", help="target HF repo, e.g. org/model")
    p.add_argument("--private", action="store_true")
    p.add_argument("--branch", default="main")
    p.add_argument("--token", default=None)
    p.add_argument("--remote-code", action="store_true",
                   help="convert to a single-repo trust_remote_code artifact first")
    p.add_argument("--device", default="cuda",
                   help="where --remote-code loads the checkpoint: cuda, or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.remote_code:
        import tempfile

        from vila_tpu_torch import entry
        from vila_tpu_torch.export import export_hf_repo
        from vila_tpu_torch.utils.device import resolve_device

        dev = resolve_device(args.device)
        cfg = entry.build_config(args.checkpoint, dtype="float32", device=dev)
        params = entry.load_params(args.checkpoint, cfg, device=dev)
        tokenizer = entry.load_tokenizer(args.checkpoint)
        out = tempfile.mkdtemp(prefix="vila_hf_export_")
        export_hf_repo(params, cfg, tokenizer, out)
        print(f"converted to remote-code artifact at {out}")
        args.checkpoint = out

    try:
        from huggingface_hub import HfApi
    except ImportError:
        raise SystemExit(
            "huggingface_hub is not installed in this environment; "
            "install it to upload checkpoints."
        )

    if not args.remote_code:
        for sub in ("llm", "vision_tower", "mm_projector"):
            if not os.path.isdir(os.path.join(args.checkpoint, sub)):
                raise SystemExit(
                    f"{args.checkpoint} is not a component checkpoint (missing {sub}/)")

    api = HfApi(token=args.token)
    api.create_repo(args.repo_id, private=args.private, exist_ok=True, repo_type="model")
    api.upload_folder(folder_path=args.checkpoint, repo_id=args.repo_id,
                      revision=args.branch, commit_message="upload vila_tpu checkpoint")
    print(f"uploaded {args.checkpoint} -> {args.repo_id}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
